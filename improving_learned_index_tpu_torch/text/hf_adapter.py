"""Optional HuggingFace tokenizer adapter.

Counterpart of ``improving_learned_index_tpu/text/hf_adapter.py``: the
``ImpactTokenizer`` surface on top of a ``transformers`` fast tokenizer,
using ``word_ids()`` for the term -> first-token map, the mechanism of the
reference XLM-R path (src/deep_impact/models/xlmr_original.py:134-164).
``transformers`` is imported only inside ``load_hf_tokenizer``; without it
that call raises ``ImportError`` (there is no fallback to WordPiece).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .normalize import PUNCTUATION
from .processor import DocumentEncoding, ImpactTokenizer, Segmenter


class HFImpactTokenizer:
    """Term processing backed by a transformers PreTrainedTokenizerFast."""

    def __init__(
        self,
        hf_tokenizer,
        max_length: int = 512,
        segmenter: Optional[Segmenter] = None,
    ):
        if not getattr(hf_tokenizer, "is_fast", False):
            raise ValueError("HFImpactTokenizer requires a fast tokenizer (word_ids support)")
        self.tokenizer = hf_tokenizer
        self.max_length = max_length
        self._segmenter = segmenter

    # -- segmentation -------------------------------------------------------
    def segment(self, text: str) -> List[str]:
        if self._segmenter is not None:
            return self._segmenter(text)
        backend = self.tokenizer.backend_tokenizer
        if backend.normalizer is not None:
            text = backend.normalizer.normalize_str(text)
        return [tok for tok, _ in backend.pre_tokenizer.pre_tokenize_str(text)]

    def process_query(self, query: str) -> Set[str]:
        return {t for t in self.segment(query) if t not in PUNCTUATION}

    # -- document -------------------------------------------------------------
    def process_document(
        self, document: str, max_length: Optional[int] = None
    ) -> DocumentEncoding:
        if max_length is None:
            max_length = self.max_length
        terms = self.segment(document)
        encoded = self.tokenizer(
            terms,
            is_split_into_words=True,
            add_special_tokens=True,
            padding="max_length",
            truncation=True,
            max_length=max_length,
        )
        term_index_to_token_index: Dict[int, int] = {}
        prev = None
        for i, widx in enumerate(encoded.word_ids()):
            if widx is None:
                continue
            if widx != prev:
                term_index_to_token_index[widx] = i
                prev = widx

        filtered: Dict[str, int] = {}
        for i, term in enumerate(terms):
            if (
                term not in filtered
                and term not in PUNCTUATION
                and i in term_index_to_token_index
            ):
                filtered[term] = term_index_to_token_index[i]

        ids = list(encoded["input_ids"])
        return DocumentEncoding(
            ids=ids,
            attention_mask=list(encoded["attention_mask"]),
            type_ids=list(encoded.get("token_type_ids", [0] * len(ids))),
            term_to_token_index=filtered,
        )

    def process_query_and_document(
        self, query: str, document: str, max_length: Optional[int] = None
    ) -> Tuple[DocumentEncoding, np.ndarray]:
        query_terms = self.process_query(query)
        encoded = self.process_document(document, max_length=max_length)
        mask = ImpactTokenizer.get_query_document_token_mask(
            query_terms, encoded.term_to_token_index, max_length or self.max_length
        )
        return encoded, mask

    get_query_document_token_mask = staticmethod(
        ImpactTokenizer.get_query_document_token_mask
    )


def load_hf_tokenizer(name_or_path: str, max_length: int = 512) -> HFImpactTokenizer:
    """A fast tokenizer from a local directory (or a hub id, which needs the
    network: pass directories)."""
    from transformers import AutoTokenizer  # gated import

    return HFImpactTokenizer(AutoTokenizer.from_pretrained(name_or_path), max_length)
