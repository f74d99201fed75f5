"""Query processing: the term contract of the ranker.

The port's copy of the query half of
``improving_learned_index_tpu/text/processor.py``, reproducing the reference
semantics (src/deep_impact/models/xlmr_original.py:114-189,
original.py:123-252): ``process_query`` normalizes and segments the text
into terms, drops punctuation, and returns the *set* of terms.  Document
processing (subword encoding, the term -> first-token map) comes with the
encoder slice.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Set

from .normalize import PUNCTUATION, normalize, pretokenize
from .wordpiece import WordPieceVocab

Segmenter = Callable[[str], List[str]]


def default_segmenter(text: str, lowercase: bool = True) -> List[str]:
    return pretokenize(normalize(text, lowercase=lowercase))


class ImpactTokenizer:
    """Self-contained tokenizer stack: normalize -> pretokenize, over a
    WordPiece vocabulary."""

    def __init__(
        self,
        vocab: WordPieceVocab,
        max_length: int = 512,
        segmenter: Optional[Segmenter] = None,
        lowercase: bool = True,
    ):
        self.vocab = vocab
        self.max_length = max_length
        self.lowercase = lowercase
        self.segmenter: Segmenter = segmenter or (
            lambda text: default_segmenter(text, lowercase=lowercase)
        )

    def process_query(self, query: str) -> Set[str]:
        terms = self.segmenter(query)
        return {t for t in terms if t not in PUNCTUATION}
