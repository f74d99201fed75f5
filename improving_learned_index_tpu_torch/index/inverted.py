"""Inverted index: CSR postings + reference-compatible binary serialization.

The port's copy of ``improving_learned_index_tpu/index/inverted.py`` for the
query and encode paths: the constructor, ``save``/``load``, the
duplicate-posting merge, and the build from (doc, {term: impact}) pairs or a
quantized forward-index file (``build``, ``from_forward_index``).  The
binary impact-store route (``from_impact_store``) and the index algebra
(``merge``, ``filter_docs``, ``split_docs``) are not ported yet.

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
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from ..core.config import (
    DOC_SCORE_BLOCK_BYTES,
    INVERTED_INDEX_DATA,
    INVERTED_INDEX_INDEX,
    INVERTED_INDEX_VOCAB,
)
from ..utils.sorting import radix_argsort

PathLike = Union[str, Path]

_RECORD_DTYPE = np.dtype([("doc_id", "<u4"), ("impact", "u1")])
_LOC_DTYPE = np.dtype("<u8")

_SCATTER_CHUNK = 1 << 25  # 32M postings per counting-scatter block


def _stable_scatter_pass(nbuckets, counts, chunk_pairs, outs) -> None:
    """One stable counting-scatter pass: distribute postings into
    ``nbuckets`` key buckets, preserving input order within a bucket.

    ``counts`` is the precomputed global key histogram (int64[nbuckets]);
    ``chunk_pairs`` yields ``(keys, (payload arrays...))`` chunks in input
    order; ``outs`` are preallocated outputs of the payload tuple's arity.
    Equivalent to ``out[:] = data[np.argsort(key, kind="stable")]`` with
    temporaries bounded by the chunk size (a whole-index stable argsort keeps
    ~24 B/posting of int64 permutations live).
    """
    fill = np.zeros(nbuckets, dtype=np.int64)  # next free slot per bucket
    np.cumsum(counts[:-1], out=fill[1:])
    for k, data in chunk_pairs:
        k = np.asarray(k)
        m = len(k)
        if m == 0:
            continue
        idx = np.argsort(k, kind="stable") if k.dtype.itemsize <= 2 else radix_argsort(k)
        ks = k[idx]
        # within-bucket rank inside this chunk: index minus run start
        starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
        runs = np.diff(np.r_[starts, m])
        pos = fill[ks] + (np.arange(m, dtype=np.int64) - np.repeat(starts, runs))
        for out, arr in zip(outs, data):
            out[pos] = np.asarray(arr)[idx]
        fill[ks[starts]] += runs


def _slice_pairs(n, key_arr, data_arrs, chunk=_SCATTER_CHUNK):
    """(keys, payload-tuple) slice chunks over materialized arrays."""
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        yield key_arr[s:e], tuple(a[s:e] for a in data_arrs)


def _combined_key(tid_sorted, cv):
    """tid * 256 + (255 - impact): term ascending, impact descending."""
    k = tid_sorted.astype(np.int32, copy=True)
    k <<= 8
    k += 255 - cv
    return k


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

    # -- construction ---------------------------------------------------------
    @classmethod
    def build(
        cls,
        doc_term_impacts: Iterable[Tuple[int, Dict[str, float]]],
        num_docs: int = 0,
    ) -> "InvertedIndexData":
        """Build from (doc_id, {term: quantized_impact}) pairs.

        Postings within a term sort by impact descending with stable doc
        order for ties (reference create.py:41 sorted(..., reverse=True)).
        Zero impacts never enter the scored CSR (they terminate reads in the
        reference's term_docs loop, inverted_index.py:49-51) but are retained
        in the zero side-CSR because the reference creator writes them to
        .dat (create.py:44-46): byte parity requires them on save().
        Postings accumulate into typed 4M-posting chunks (9 B/posting), and
        the order comes from chunked stable counting-scatter passes.
        """
        chunk = 1 << 22
        vocab_map: Dict[str, int] = {}
        terms: List[str] = []
        chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        c_tid = np.empty(chunk, np.int32)
        c_doc = np.empty(chunk, np.uint32)
        c_val = np.empty(chunk, np.uint8)
        fill = 0
        max_doc = -1
        # a doc id fed twice can create duplicate (term, doc) postings; track
        # cheaply (1 bit/doc) and dedupe-sum in _finalize only when flagged
        seen = np.zeros(1 << 16, bool)
        maybe_dup = False
        for doc_id, impacts in doc_term_impacts:
            max_doc = max(max_doc, doc_id)
            if doc_id >= len(seen):
                grown = np.zeros(max(len(seen) * 2, doc_id + 1), bool)
                grown[: len(seen)] = seen
                seen = grown
            if seen[doc_id]:
                maybe_dup = True
            seen[doc_id] = True
            for term, val in impacts.items():
                v = min(max(0, int(val)), 255)
                tid = vocab_map.get(term)
                if tid is None:
                    tid = len(vocab_map)
                    vocab_map[term] = tid
                    terms.append(term)
                if fill == chunk:
                    chunks.append((c_tid, c_doc, c_val))
                    c_tid = np.empty(chunk, np.int32)
                    c_doc = np.empty(chunk, np.uint32)
                    c_val = np.empty(chunk, np.uint8)
                    fill = 0
                c_tid[fill] = tid
                c_doc[fill] = doc_id
                c_val[fill] = v
                fill += 1
        chunks.append((c_tid[:fill], c_doc[:fill], c_val[:fill]))
        return cls._finalize(terms, chunks, num_docs, max_doc, check_dups=maybe_dup)

    @classmethod
    def _finalize(
        cls,
        terms: List[str],
        chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        num_docs: int,
        max_doc: int,
        check_dups: bool = False,
    ) -> "InvertedIndexData":
        """CSR construction from typed posting chunks (tid int32 in
        insertion order, doc uint32, impact uint8); the list's entries are
        freed as they are consumed.

        The (term asc, impact desc, doc asc) order comes from stable
        counting-scatter passes: ONE pass on the combined key
        tid*256 + (255-impact) when the bucket table fits (vocab <= 131072),
        else impact-descending then term-ascending; doc order rides on
        stability."""
        # Re-map term ids to sorted-vocab order (reference vocab.txt is sorted).
        order = np.argsort(terms, kind="stable")
        sorted_vocab = [terms[i] for i in order]
        nvocab = len(sorted_vocab)
        tid_dtype = (np.uint16 if nvocab <= (1 << 16)
                     else np.int32 if nvocab < (1 << 31) else np.int64)
        remap = np.empty(max(len(terms), 1), dtype=tid_dtype)
        remap[order] = np.arange(len(terms), dtype=tid_dtype)

        n = sum(len(c[0]) for c in chunks)
        combined = 0 < nvocab <= (1 << 17)
        nz_counts = np.zeros(nvocab, np.int64)
        z_counts = np.zeros(nvocab, np.int64)
        key_counts = np.zeros(nvocab * 256, np.int64) if combined else None
        imp_counts = np.zeros(256, np.int64)
        has_zeros = False

        tid_in = np.empty(n, tid_dtype)
        doc_in = np.empty(n, np.uint32)
        val_in = np.empty(n, np.uint8)
        at = 0
        while chunks:
            ct, cd, cv = chunks.pop(0)
            m = len(ct)
            tid_sorted = remap[np.asarray(ct)]
            cv = np.asarray(cv, dtype=np.uint8)
            tid_in[at : at + m] = tid_sorted
            doc_in[at : at + m] = cd
            val_in[at : at + m] = cv
            if (cv == 0).any():
                has_zeros = True
                nz_counts += np.bincount(tid_sorted[cv > 0], minlength=nvocab)
                z_counts += np.bincount(tid_sorted[cv == 0], minlength=nvocab)
            else:
                nz_counts += np.bincount(tid_sorted, minlength=nvocab)
            if combined:
                key_counts += np.bincount(_combined_key(tid_sorted, cv), minlength=nvocab * 256)
            else:
                imp_counts += np.bincount(cv, minlength=256)
            at += m

        def src():
            for s in range(0, n, _SCATTER_CHUNK):
                e = min(s + _SCATTER_CHUNK, n)
                yield tid_in[s:e], doc_in[s:e], val_in[s:e]

        doc_arr = np.empty(n, np.uint32)
        val_arr = np.empty(n, np.uint8)
        if n and combined:
            _stable_scatter_pass(
                nvocab * 256, key_counts,
                ((_combined_key(t, v), (d, v)) for t, d, v in src()),
                (doc_arr, val_arr),
            )
        elif n:
            # wide vocab: impact pass into intermediates, then term pass
            tid1 = np.empty(n, tid_dtype)
            doc1 = np.empty(n, np.uint32)
            val1 = np.empty(n, np.uint8)
            _stable_scatter_pass(
                256, imp_counts[::-1].copy(),
                ((255 - v, (t, d, v)) for t, d, v in src()),
                (tid1, doc1, val1),
            )
            del tid_in, doc_in, val_in
            _stable_scatter_pass(
                nvocab, nz_counts + z_counts,
                _slice_pairs(n, tid1, (doc1, val1)),
                (doc_arr, val_arr),
            )
            del tid1, doc1, val1

        def _offsets(counts):
            out = np.zeros(nvocab + 1, dtype=np.int64)
            np.cumsum(counts, out=out[1:])
            return out

        if not has_zeros:
            inst = cls(
                sorted_vocab, _offsets(nz_counts), doc_arr, val_arr,
                num_docs=max(num_docs, max_doc + 1),
            )
        else:
            # zeros have the largest within-term key (255 - 0), so each
            # term's zero records form the segment tail
            nonzero = val_arr > 0
            inst = cls(
                sorted_vocab,
                _offsets(nz_counts),
                doc_arr[nonzero],
                val_arr[nonzero],
                num_docs=max(num_docs, max_doc + 1),
                zero_offsets=_offsets(z_counts),
                zero_doc_ids=doc_arr[~nonzero],
            )
        if check_dups:
            inst._dedupe_sum_duplicates()
        return inst

    @classmethod
    def from_forward_index(cls, index_path: PathLike, num_docs: int = 0) -> "InvertedIndexData":
        from .forward_index import iter_forward_index

        return cls.build(iter_forward_index(index_path), num_docs=num_docs)

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
