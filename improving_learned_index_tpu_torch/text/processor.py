"""Document/query processing: the term -> first-token contract.

The port's copy of ``improving_learned_index_tpu/text/processor.py``, the
host-side hot path feeding the encoder.  It reproduces the reference
semantics (src/deep_impact/models/xlmr_original.py:114-189,
original.py:123-252):

- ``process_query``    : normalize + segment into terms, drop punctuation,
                         return the *set* of terms.
- ``process_document`` : normalize + segment into terms, subword-encode with
                         special tokens, pad/truncate to ``max_length``, and
                         map each unique non-punctuation term to the index of
                         its **first subword token** (duplicates keep the
                         first occurrence; terms whose tokens overflow are
                         dropped).

Segmentation is pluggable (whitespace/punctuation default; any callable).
Fixed-shape batching helpers produce the int32 arrays the encoder consumes:
documents padded to ``max_length`` and term slots to ``max_terms``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.profiling import annotate
from .normalize import PUNCTUATION, normalize, pretokenize
from .wordpiece import WordPieceTokenizer, WordPieceVocab

Segmenter = Callable[[str], List[str]]


def default_segmenter(text: str, lowercase: bool = True) -> List[str]:
    return pretokenize(normalize(text, lowercase=lowercase))


@dataclasses.dataclass
class DocumentEncoding:
    """Fixed-length encoded document + term map (the fields the reference
    reads off its MockEncoding: ids/attention_mask/type_ids)."""

    ids: List[int]
    attention_mask: List[int]
    type_ids: List[int]
    term_to_token_index: Dict[str, int]


class ImpactTokenizer:
    """Self-contained tokenizer stack: normalize -> pretokenize ->
    WordPiece, with the term -> first-token map built during assembly."""

    def __init__(
        self,
        vocab: WordPieceVocab,
        max_length: int = 512,
        segmenter: Optional[Segmenter] = None,
        lowercase: bool = True,
    ):
        self.vocab = vocab
        self.wordpiece = WordPieceTokenizer(vocab)
        self.max_length = max_length
        self.lowercase = lowercase
        self.segmenter: Segmenter = segmenter or (
            lambda text: default_segmenter(text, lowercase=lowercase)
        )

    # -- query ------------------------------------------------------------
    def process_query(self, query: str) -> Set[str]:
        """The query's terms: the region ``text/process_query``."""
        with annotate("text/process_query"):
            return self._query_terms(query)

    def _query_terms(self, query: str) -> Set[str]:
        terms = self.segmenter(query)
        return {t for t in terms if t not in PUNCTUATION}

    # -- document ---------------------------------------------------------
    def process_document(
        self, document: str, max_length: Optional[int] = None
    ) -> DocumentEncoding:
        if max_length is None:
            max_length = self.max_length
        terms = self.segmenter(document)

        ids: List[int] = [self.vocab.cls_id]
        term_index_to_token_index: Dict[int, int] = {}
        budget = max_length - 1  # reserve [SEP]
        for term_idx, term in enumerate(terms):
            if len(ids) >= budget:
                break
            piece_ids = self.wordpiece.tokenize_word(term)
            term_index_to_token_index[term_idx] = len(ids)
            take = min(len(piece_ids), budget - len(ids))
            ids.extend(piece_ids[:take])
        ids.append(self.vocab.sep_id)

        attention_mask = [1] * len(ids)
        if len(ids) < max_length:
            pad = max_length - len(ids)
            ids = ids + [self.vocab.pad_id] * pad
            attention_mask = attention_mask + [0] * pad

        # Filter duplicates / punctuation / overflowed terms
        # (reference xlmr_original.py:181-189).
        filtered: Dict[str, int] = {}
        for i, term in enumerate(terms):
            if (
                term not in filtered
                and term not in PUNCTUATION
                and i in term_index_to_token_index
            ):
                filtered[term] = term_index_to_token_index[i]

        return DocumentEncoding(
            ids=ids,
            attention_mask=attention_mask,
            type_ids=[0] * max_length,
            term_to_token_index=filtered,
        )

    def process_query_and_document(
        self, query: str, document: str, max_length: Optional[int] = None
    ) -> Tuple[DocumentEncoding, np.ndarray]:
        """Returns (encoded document, bool mask over tokens marking the first
        tokens of document terms that appear in the query) -- the training
        target mask (reference xlmr_original.py:87-112)."""
        # a training loader thread calls this: no region
        query_terms = self._query_terms(query)
        encoded = self.process_document(document, max_length=max_length)
        mask = self.get_query_document_token_mask(
            query_terms, encoded.term_to_token_index, max_length or self.max_length
        )
        return encoded, mask

    @staticmethod
    def get_query_document_token_mask(
        query_terms: Set[str], term_to_token_index: Dict[str, int], max_length: int
    ) -> np.ndarray:
        mask = np.zeros(max_length, dtype=bool)
        idxs = [v for k, v in term_to_token_index.items() if k in query_terms]
        mask[idxs] = True
        return mask


# ---------------------------------------------------------------------------
# Fixed-shape batching for the device
# ---------------------------------------------------------------------------

def batch_arrays(encodings: Sequence[DocumentEncoding]) -> Dict[str, np.ndarray]:
    """Stack encodings into the int32 arrays the encoder consumes."""
    return {
        "input_ids": np.asarray([e.ids for e in encodings], dtype=np.int32),
        "attention_mask": np.asarray(
            [e.attention_mask for e in encodings], dtype=np.int32
        ),
        "type_ids": np.asarray([e.type_ids for e in encodings], dtype=np.int32),
    }


def batch_term_slots(
    encodings: Sequence[DocumentEncoding], max_terms: int
) -> Tuple[np.ndarray, np.ndarray, List[List[str]]]:
    """Pad per-document term->token maps to a fixed [B, max_terms] slot array.

    Returns (slots int32 [B,T] with 0 padding, valid bool [B,T], terms list).
    The device gathers token scores at ``slots``; hosts map slot j of doc i
    back to ``terms[i][j]``.
    """
    bsz = len(encodings)
    slots = np.zeros((bsz, max_terms), dtype=np.int32)
    valid = np.zeros((bsz, max_terms), dtype=bool)
    all_terms: List[List[str]] = []
    for i, enc in enumerate(encodings):
        items = list(enc.term_to_token_index.items())[:max_terms]
        all_terms.append([t for t, _ in items])
        for j, (_, tok_idx) in enumerate(items):
            slots[i, j] = tok_idx
            valid[i, j] = True
    return slots, valid, all_terms
