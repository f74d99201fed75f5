"""Inverted index: CSR postings + reference-compatible binary serialization.

The port's copy of ``improving_learned_index_tpu/index/inverted.py`` for the
query path: the constructor, ``save``/``load`` and the duplicate-posting
merge.  Building an index (``build``, ``from_forward_index``,
``from_impact_store``, ``merge``, ``filter_docs``, ``split_docs``) comes with
the index-build slice.

In memory the index is three flat numpy arrays (CSR layout) — what the
query engine uploads to the card once:

    offsets : int64[V+1]   postings range per term id
    doc_ids : uint32[P]
    impacts : uint8[P]     8-bit quantized, sorted descending within a term

On disk the layout is bit-for-bit the reference format
(src/deep_impact/inverted_index/create.py:19-51, utils/defaults.py:22-37):
``vocab.txt`` (sorted terms, one per line), ``inverted_index.dat`` (packed
little-endian uint32 doc_id + uint8 impact records), ``inverted_index.idx``
(two uint64 byte offsets [start, end) per term, vocab order).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from ..core.config import (
    DOC_SCORE_BLOCK_BYTES,
    INVERTED_INDEX_DATA,
    INVERTED_INDEX_INDEX,
    INVERTED_INDEX_VOCAB,
)

PathLike = Union[str, Path]

_RECORD_DTYPE = np.dtype([("doc_id", "<u4"), ("impact", "u1")])
_LOC_DTYPE = np.dtype("<u8")


class InvertedIndexData:
    """CSR postings over a term vocabulary."""

    def __init__(
        self,
        vocab: List[str],
        offsets: np.ndarray,
        doc_ids: np.ndarray,
        impacts: np.ndarray,
        num_docs: int = 0,
        zero_offsets: np.ndarray = None,
        zero_doc_ids: np.ndarray = None,
    ):
        if offsets.shape != (len(vocab) + 1,):
            raise ValueError(f"offsets shape {offsets.shape} != ({len(vocab) + 1},)")
        if doc_ids.shape != impacts.shape:
            raise ValueError("doc_ids and impacts differ in shape")
        self.vocab = vocab
        self.term_to_id: Dict[str, int] = {t: i for i, t in enumerate(vocab)}
        # ascontiguousarray: no copy when dtype/layout already match (astype
        # always copies — 2x the .dat bytes transiently at corpus scale)
        self.offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.doc_ids = np.ascontiguousarray(doc_ids, dtype=np.uint32)
        self.impacts = np.ascontiguousarray(impacts, dtype=np.uint8)
        # Zero-quantized postings: never scored (the reference reader stops at
        # the first zero impact, inverted_index.py:49-51) but written to .dat
        # by the reference creator (create.py:41-46 writes every int(val),
        # including 0) — kept in a side CSR purely for byte-parity save().
        if zero_offsets is None:
            zero_offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
            zero_doc_ids = np.empty(0, dtype=np.uint32)
        self.zero_offsets = zero_offsets.astype(np.int64)
        self.zero_doc_ids = zero_doc_ids.astype(np.uint32)
        self.num_docs = num_docs or (int(doc_ids.max()) + 1 if len(doc_ids) else 0)

    def __len__(self) -> int:
        return len(self.vocab)

    @property
    def num_postings(self) -> int:
        return int(self.offsets[-1])

    def term_postings(self, term: str) -> Tuple[np.ndarray, np.ndarray]:
        tid = self.term_to_id.get(term)
        if tid is None:
            return np.empty(0, np.uint32), np.empty(0, np.uint8)
        s, e = self.offsets[tid], self.offsets[tid + 1]
        return self.doc_ids[s:e], self.impacts[s:e]

    def _dedupe_sum_duplicates(self, block: int = 8 << 20) -> None:
        """Merge duplicate (term, doc) postings in place: impacts sum and
        saturate at 255 — the quantization-lattice semantics, and the
        reference creator's one-posting-per-pair invariant
        (create.py:41-45).  Keeps (impact desc, doc asc) order within each
        term; the zero side-CSR is untouched (zero impacts add nothing to
        scores).  Memory is bounded by ~``block``-posting term slabs."""
        n = len(self.doc_ids)
        if n == 0:
            return
        stride = np.int64(max(self.num_docs, int(self.doc_ids.max()) + 1))
        out_docs: List[np.ndarray] = []
        out_vals: List[np.ndarray] = []
        new_counts = np.zeros(len(self.vocab), np.int64)
        changed = False
        t0 = 0
        nvocab = len(self.vocab)
        while t0 < nvocab:
            t1 = int(np.searchsorted(self.offsets, self.offsets[t0] + block))
            t1 = min(max(t1, t0 + 1), nvocab)
            lo, hi = int(self.offsets[t0]), int(self.offsets[t1])
            seg_lens = np.diff(self.offsets[t0 : t1 + 1])
            tid_rel = np.repeat(np.arange(t1 - t0, dtype=np.int64), seg_lens)
            key = tid_rel * stride + self.doc_ids[lo:hi]
            uniq, inv, cnt = np.unique(
                key, return_inverse=True, return_counts=True
            )
            if (cnt > 1).any():
                changed = True
                vals = np.minimum(
                    np.bincount(inv, weights=self.impacts[lo:hi]), 255
                ).astype(np.uint8)
                docs = (uniq % stride).astype(np.uint32)
                tids = uniq // stride
                order = np.lexsort((docs, vals.astype(np.int16) * -1, tids))
                out_docs.append(docs[order])
                out_vals.append(vals[order])
                new_counts[t0:t1] = np.bincount(tids, minlength=t1 - t0)
            else:
                out_docs.append(self.doc_ids[lo:hi])
                out_vals.append(self.impacts[lo:hi])
                new_counts[t0:t1] = seg_lens
            t0 = t1
        if not changed:
            return
        self.doc_ids = np.concatenate(out_docs)
        self.impacts = np.concatenate(out_vals)
        offsets = np.zeros(nvocab + 1, np.int64)
        np.cumsum(new_counts, out=offsets[1:])
        self.offsets = offsets

    # -- serialization (reference binary layout) -------------------------------
    def save(self, output_path: PathLike) -> None:
        out = Path(output_path)
        out.mkdir(parents=True, exist_ok=True)
        with open(out / INVERTED_INDEX_VOCAB, "w", encoding="utf-8") as f:
            for term in self.vocab:
                f.write(term + "\n")

        # Per term: scored (nonzero) records first — already impact-sorted —
        # then the zero-impact records, matching the reference's descending
        # sort where zeros land last (create.py:41-46).  Written in term
        # slabs of ~4M postings so the interleave buffer never holds the
        # whole .dat in RAM.
        n_main = np.diff(self.offsets)
        n_zero = np.diff(self.zero_offsets)
        full_offsets = np.zeros(len(self.vocab) + 1, dtype=np.int64)
        np.cumsum(n_main + n_zero, out=full_offsets[1:])

        _SLAB = 1 << 22
        with open(out / INVERTED_INDEX_DATA, "wb") as f:
            t0 = 0
            nvocab = len(self.vocab)
            while t0 < nvocab:
                t1 = t0
                while t1 < nvocab and full_offsets[t1 + 1] - full_offsets[t0] <= _SLAB:
                    t1 += 1
                t1 = max(t1, t0 + 1)  # a single term may exceed the slab
                slab = np.empty(
                    int(full_offsets[t1] - full_offsets[t0]), dtype=_RECORD_DTYPE
                )
                base = full_offsets[t0]
                nm, nz = n_main[t0:t1], n_zero[t0:t1]
                if nm.sum():
                    s, e = self.offsets[t0], self.offsets[t1]
                    term_of = np.repeat(np.arange(t0, t1), nm)
                    within = np.arange(s, e) - self.offsets[term_of]
                    pos = full_offsets[term_of] - base + within
                    slab["doc_id"][pos] = self.doc_ids[s:e]
                    slab["impact"][pos] = self.impacts[s:e]
                if nz.sum():
                    s, e = self.zero_offsets[t0], self.zero_offsets[t1]
                    term_of = np.repeat(np.arange(t0, t1), nz)
                    within = np.arange(s, e) - self.zero_offsets[term_of]
                    pos = full_offsets[term_of] - base + n_main[term_of] + within
                    slab["doc_id"][pos] = self.zero_doc_ids[s:e]
                    slab["impact"][pos] = 0
                slab.tofile(f)
                t0 = t1

        locs = np.empty(2 * len(self.vocab), dtype=_LOC_DTYPE)
        byte_offsets = full_offsets * DOC_SCORE_BLOCK_BYTES
        locs[0::2] = byte_offsets[:-1].astype(np.uint64)
        locs[1::2] = byte_offsets[1:].astype(np.uint64)
        locs.tofile(out / INVERTED_INDEX_INDEX)

    @classmethod
    def load(cls, index_path: PathLike, num_docs: int = 0) -> "InvertedIndexData":
        path = Path(index_path)
        with open(path / INVERTED_INDEX_VOCAB, encoding="utf-8") as f:
            vocab = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        records = np.fromfile(path / INVERTED_INDEX_DATA, dtype=_RECORD_DTYPE)
        locs = np.fromfile(path / INVERTED_INDEX_INDEX, dtype=_LOC_DTYPE).reshape(-1, 2)
        if locs.shape[0] != len(vocab):
            raise ValueError("idx/vocab size mismatch")
        full_offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
        if len(vocab):
            full_offsets[:-1] = locs[:, 0] // DOC_SCORE_BLOCK_BYTES
            full_offsets[-1] = locs[-1, 1] // DOC_SCORE_BLOCK_BYTES
            # Reference .idx ranges are contiguous; trust ends for safety.
            if not np.all(locs[:, 1] // DOC_SCORE_BLOCK_BYTES == full_offsets[1:]):
                raise ValueError("non-contiguous postings")

        # Split zero-impact records (a per-term suffix under the descending
        # sort; the reference reader never scores them) into the side CSR so
        # a save() round-trips byte-for-bit.
        impacts = records["impact"]
        if impacts.all():
            # Common case — an index written by quantize (which drops zeros)
            # has no zero-impact records: the scored CSR IS the file.
            return cls(
                vocab,
                full_offsets,
                records["doc_id"].copy(),
                impacts.copy(),
                num_docs=num_docs,
            )
        nonzero = impacts != 0
        nz_pref = np.zeros(len(records) + 1, dtype=np.int64)
        np.cumsum(nonzero, out=nz_pref[1:])
        offsets = nz_pref[full_offsets]
        # zeros-before-k = k - nonzeros-before-k: no second cumsum
        zero_offsets = full_offsets - offsets
        return cls(
            vocab,
            offsets,
            records["doc_id"][nonzero].copy(),
            impacts[nonzero].copy(),
            num_docs=num_docs,
            zero_offsets=zero_offsets,
            zero_doc_ids=records["doc_id"][~nonzero].copy(),
        )


def index_from_numpy(
    vocab: List[str],
    offsets: np.ndarray,
    doc_ids: np.ndarray,
    impacts: np.ndarray,
    num_docs: int = 0,
    zero_offsets: Optional[np.ndarray] = None,
    zero_doc_ids: Optional[np.ndarray] = None,
) -> InvertedIndexData:
    """The port's index from another holder's numpy arrays (for example the
    JAX package's ``InvertedIndexData``), copied so the two objects share
    no buffer: the same state scored by both packages."""
    return InvertedIndexData(
        list(vocab),
        np.array(offsets, dtype=np.int64),
        np.array(doc_ids, dtype=np.uint32),
        np.array(impacts, dtype=np.uint8),
        num_docs=num_docs,
        zero_offsets=None if zero_offsets is None else np.array(zero_offsets),
        zero_doc_ids=None if zero_doc_ids is None else np.array(zero_doc_ids),
    )
