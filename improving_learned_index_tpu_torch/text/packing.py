"""Sequence packing for the corpus-encode path (the port's copy of
``improving_learned_index_tpu/text/packing.py``, numpy only).

Real collections are short: MSMARCO passages average ~70 subword tokens, but
the encoder's batch shape is [B, max_length] (256/512).  The reference pads
every document to max_length (src/deep_impact/models/original.py:200-226
``padding='max_length'``), so ~70% of its GPU FLOPs hit padding.  The fix:
pack several documents into each [S] row, restrict attention to
within-document tokens via **segment ids** (block-diagonal masking, exact
zeros after softmax -- packed scores match unpacked up to matmul tiling),
and restart position ids per document.

Host-side layout produced here, consumed by ``DeepImpact.encode_packed``:

- ``input_ids / segment_ids / type_ids``: [R, S] int32.  ``segment_ids`` is 0
  on padding and 1..n_docs_in_row within a row; position ids are derived from
  it on device (models/encoder.make_packed_position_ids), so the packer stays
  model-agnostic.
- term gather is FLAT: one [P] int32 array of ``row * S + col`` token slots
  (every document's term slots contiguous, documents in order) plus host-side
  ``term_offsets`` to split the gathered [P] scores per document.  This
  replaces the per-doc [B, max_terms] slot matrix — no padding in the
  transfer at all.

The packer is greedy first-fit in arrival order (stable: document order in
the forward index is preserved, which the store/text writers require).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Sequence

import numpy as np

from .processor import DocumentEncoding


@dataclass
class PackedBatch:
    """One device batch of packed documents."""

    input_ids: np.ndarray    # [R, S] int32
    segment_ids: np.ndarray  # [R, S] int32; 0 = padding
    type_ids: np.ndarray     # [R, S] int32
    flat_slots: np.ndarray   # [P] int32 (row * S + col), padded with 0
    term_offsets: np.ndarray  # [n_docs + 1] int64 into the gathered scores
    terms: List[List[str]]   # per-document term lists, arrival order

    @property
    def n_docs(self) -> int:
        return len(self.terms)


def _doc_len(enc: DocumentEncoding) -> int:
    # attention_mask is 1 on real tokens; documents are already truncated to
    # the tokenizer's max_length.  Packing slices ids[:n], which requires the
    # real tokens leading and the padding trailing (right padding — both
    # in-repo tokenizers and HF's default).
    n = int(sum(enc.attention_mask))
    if n and (enc.attention_mask[0] != 1 or any(enc.attention_mask[n:])):
        raise ValueError("sequence packing requires right-padded encodings")
    return n


class SequencePacker:
    """Greedy streaming packer with a fixed compiled shape.

    Emits a batch when the next document would overflow either the row budget
    (``rows`` rows of ``seq_len``) or the flat slot budget (``slot_cap``,
    default rows*seq_len — every token a term, never overflows).  Documents
    longer than ``seq_len`` are an error: the tokenizer's max_length must be
    <= seq_len.
    """

    def __init__(self, seq_len: int, rows: int, max_terms: int | None = None):
        if rows < 1 or seq_len < 2:
            raise ValueError(f"bad packer geometry rows={rows} seq_len={seq_len}")
        self.seq_len = seq_len
        self.rows = rows
        self.max_terms = max_terms if max_terms is not None else seq_len
        self.slot_cap = rows * seq_len
        self._reset()

    def _reset(self) -> None:
        s, r = self.seq_len, self.rows
        self._ids = np.zeros((r, s), dtype=np.int32)
        self._seg = np.zeros((r, s), dtype=np.int32)
        self._typ = np.zeros((r, s), dtype=np.int32)
        self._slots: List[np.ndarray] = []
        self._offsets: List[int] = [0]
        self._terms: List[List[str]] = []
        self._row = 0          # current fill row
        self._col = 0          # next free column in the fill row
        self._row_seg = 0      # segments already in the fill row
        self._n_slots = 0

    def _emit(self) -> PackedBatch:
        flat = (
            np.concatenate(self._slots)
            if self._slots
            else np.zeros((0,), dtype=np.int32)
        )
        if flat.size < self.slot_cap:
            flat = np.concatenate(
                [flat, np.zeros(self.slot_cap - flat.size, dtype=np.int32)]
            )
        batch = PackedBatch(
            input_ids=self._ids,
            segment_ids=self._seg,
            type_ids=self._typ,
            flat_slots=flat.astype(np.int32),
            term_offsets=np.asarray(self._offsets, dtype=np.int64),
            terms=self._terms,
        )
        self._reset()
        return batch

    def add(self, enc: DocumentEncoding) -> Iterator[PackedBatch]:
        """Place one document; yields a finished batch when one fills up.

        Generator: the placement happens lazily on iteration — callers must
        always drain the returned iterator (``for b in packer.add(e)`` /
        ``yield from``), even though it usually yields nothing."""
        n = _doc_len(enc)
        if n > self.seq_len:
            raise ValueError(
                f"document of {n} tokens exceeds packer seq_len {self.seq_len}"
            )
        if n == 0:  # degenerate empty encoding: still takes a (terms=[]) slot
            self._terms.append([])
            self._offsets.append(self._n_slots)
            return
        if self._col + n > self.seq_len:  # doesn't fit the fill row
            self._row += 1
            self._col = 0
            self._row_seg = 0
        items = list(enc.term_to_token_index.items())[: self.max_terms]
        if self._row >= self.rows or self._n_slots + len(items) > self.slot_cap:
            yield self._emit()
        r, c = self._row, self._col
        self._ids[r, c : c + n] = enc.ids[:n]
        self._typ[r, c : c + n] = enc.type_ids[:n]
        self._row_seg += 1
        self._seg[r, c : c + n] = self._row_seg
        base = r * self.seq_len + c
        slots = np.asarray([base + tok for _, tok in items], dtype=np.int32)
        self._slots.append(slots)
        self._n_slots += len(items)
        self._offsets.append(self._n_slots)
        self._terms.append([t for t, _ in items])
        self._col = c + n

    def flush(self) -> Iterator[PackedBatch]:
        if self._terms or self._col or self._row:
            yield self._emit()


def pack_documents(
    encodings: Sequence[DocumentEncoding] | Iterator[DocumentEncoding],
    seq_len: int,
    rows: int,
    max_terms: int | None = None,
) -> Iterator[PackedBatch]:
    """Pack a stream of encodings into fixed-shape batches."""
    packer = SequencePacker(seq_len, rows, max_terms)
    for enc in encodings:
        yield from packer.add(enc)
    yield from packer.flush()
