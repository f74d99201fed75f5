"""Inverted index: CSR postings + reference-compatible binary serialization.

The port's copy of ``improving_learned_index_tpu/index/inverted.py``: the
constructor, ``save``/``load``, the duplicate-posting merge, the build from
(doc, {term: impact}) pairs, a quantized forward-index file or a quantized
binary impact store (``build``, ``from_forward_index``,
``from_impact_store``), and the index algebra (``merge``, ``filter_docs``,
``delete_docs``, ``split_docs``).  Every route writes the JAX package's
bytes on ``save``.

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
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

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


def _consume_chunks(chunks):
    """Yield posting chunks, releasing list entries as they are consumed
    (a popped chunk's arrays free once copied); iterators pass through."""
    if isinstance(chunks, list):
        while chunks:
            yield chunks.pop(0)
    else:
        yield from chunks


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
        chunks,
        num_docs: int,
        max_doc: int,
        compact: bool = False,
        total: Optional[int] = None,
        check_dups: bool = False,
    ) -> "InvertedIndexData":
        """CSR construction from typed posting chunks (tid int32 in
        insertion order, doc uint32, impact uint8).

        ``chunks`` is a list (entries freed as they are consumed), an
        iterator (with ``total`` giving the posting count up front), or a
        zero-arg callable returning a fresh chunk iterator: the streaming
        mode of ``from_impact_store``, where the source is read twice (once
        to count, once to scatter) and no input posting column is ever
        materialized whole.

        ``compact=True`` drops vocab entries with no postings (a caller's
        possibly-superset vocab, e.g. a quantized impact store's); empty
        terms occupy no keys, so that is a counts/vocab subset after the
        counting, no extra pass over the postings.

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

        streaming = callable(chunks)
        if total is None:
            if streaming:
                raise ValueError("streaming chunks need an explicit total")
            chunks = list(chunks)
            total = sum(len(c[0]) for c in chunks)
        n = total
        combined = 0 < nvocab <= (1 << 17)
        nz_counts = np.zeros(nvocab, np.int64)
        z_counts = np.zeros(nvocab, np.int64)
        key_counts = np.zeros(nvocab * 256, np.int64) if combined else None
        imp_counts = np.zeros(256, np.int64)
        has_zeros = False

        def count_chunk(tid_sorted, cv):
            nonlocal has_zeros
            if (cv == 0).any():
                has_zeros = True
                nz_counts[:] += np.bincount(tid_sorted[cv > 0], minlength=nvocab)
                z_counts[:] += np.bincount(tid_sorted[cv == 0], minlength=nvocab)
            else:
                nz_counts[:] += np.bincount(tid_sorted, minlength=nvocab)
            if combined:
                key_counts[:] += np.bincount(_combined_key(tid_sorted, cv), minlength=nvocab * 256)
            else:
                imp_counts[:] += np.bincount(cv, minlength=256)

        if streaming:
            at = 0
            for ct, _, cv in chunks():
                cv = np.asarray(cv)
                count_chunk(remap[np.asarray(ct)], cv)
                at += len(cv)
            if at != n:
                raise ValueError(f"chunk total {at} != declared total {n}")

            def src():
                for ct, cd, cv in chunks():
                    yield remap[np.asarray(ct)], np.asarray(cd), np.asarray(cv)
        else:
            tid_in = np.empty(n, tid_dtype)
            doc_in = np.empty(n, np.uint32)
            val_in = np.empty(n, np.uint8)
            at = 0
            for ct, cd, cv in _consume_chunks(chunks):
                m = len(ct)
                tid_sorted = remap[np.asarray(ct)]
                tid_in[at : at + m] = tid_sorted
                doc_in[at : at + m] = cd
                val_in[at : at + m] = cv
                count_chunk(tid_sorted, np.asarray(cv, dtype=np.uint8))
                at += m
            if at != n:
                raise ValueError(f"chunk total {at} != declared total {n}")

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
            if not streaming:
                del tid_in, doc_in, val_in
            _stable_scatter_pass(
                nvocab, nz_counts + z_counts,
                _slice_pairs(n, tid1, (doc1, val1)),
                (doc_arr, val_arr),
            )
            del tid1, doc1, val1

        if compact:
            occurs = (nz_counts + z_counts) > 0
            if not occurs.all():
                sorted_vocab = [t for t, k in zip(sorted_vocab, occurs) if k]
                nz_counts = nz_counts[occurs]
                z_counts = z_counts[occurs]
                nvocab = len(sorted_vocab)

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

    @classmethod
    def from_impact_store(cls, store) -> "InvertedIndexData":
        """Array-speed build from a quantized binary impact store
        (index/impact_store.py), no text parse; byte-identical on save() to
        the text pipeline's index for the same corpus."""
        from .impact_store import ImpactStore

        if not isinstance(store, ImpactStore):
            store = ImpactStore(store)
        if not store.quantized:
            raise ValueError(
                "from_impact_store needs a quantized store (run quantize_store "
                "first; the inverted index holds uint8 impacts)"
            )
        # Doc-aligned chunks off the memory-mapped store: term ids and
        # values are memmap slices, the doc-id column is generated per chunk.
        offsets = np.asarray(store.offsets, dtype=np.int64)
        n_docs = store.num_docs

        def chunk_iter():
            d0 = 0
            while d0 < n_docs:
                d1 = int(np.searchsorted(offsets, offsets[d0] + _SCATTER_CHUNK, side="right")) - 1
                d1 = min(max(d1, d0 + 1), n_docs)
                s, e = int(offsets[d0]), int(offsets[d1])
                yield (
                    store.term_ids[s:e],
                    np.repeat(np.arange(d0, d1, dtype=np.uint32),
                              np.asarray(store.counts[d0:d1], dtype=np.int64)),
                    store.values[s:e],
                )
                d0 = d1

        # Text-route semantics: the index vocab is the terms that OCCUR in
        # the quantized input (quantize drops all-zero terms from the text),
        # so compact=True drops store vocab entries with no postings.
        return cls._finalize(
            list(store.vocab), chunk_iter, num_docs=n_docs, max_doc=n_docs - 1,
            compact=True, total=store.num_postings,
        )

    # -- index algebra ---------------------------------------------------------
    @classmethod
    def merge(
        cls,
        indexes: Sequence["InvertedIndexData"],
        doc_offsets: Optional[Sequence[int]] = None,
    ) -> "InvertedIndexData":
        """Merge indexes built over corpus shards into one index
        (incremental indexing: encode only the new documents, then merge).

        ``doc_offsets[i]`` is added to every doc id of ``indexes[i]``
        (default: cumulative ``num_docs``, i.e. consecutive slices).  With
        disjoint ranges the result is byte-identical on save() to a one-shot
        build over the concatenated corpus: within a (term, impact) group
        shard i's ids all precede shard i+1's.  Overlapping ranges can alias
        one (term, doc) pair across indexes; those impacts are summed,
        saturating at 255 (``_dedupe_sum_duplicates``), and disjoint ranges
        skip that pass."""
        if doc_offsets is None:
            doc_offsets = np.concatenate(
                ([0], np.cumsum([ix.num_docs for ix in indexes])[:-1])
            ).tolist()
        vocab = sorted(set().union(*(ix.vocab for ix in indexes)))
        vocab_arr = np.array(vocab)
        chunks: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for ix, off in zip(indexes, doc_offsets):
            if len(ix.vocab) == 0:
                continue
            remap = np.searchsorted(vocab_arr, np.array(ix.vocab)).astype(np.int64)
            tid = np.repeat(remap, np.diff(ix.offsets)).astype(np.int32)
            chunks.append((tid, (ix.doc_ids + off).astype(np.uint32), ix.impacts))
            n_zero = np.diff(ix.zero_offsets)
            if n_zero.sum():
                ztid = np.repeat(remap, n_zero).astype(np.int32)
                chunks.append((ztid, (ix.zero_doc_ids + off).astype(np.uint32),
                               np.zeros(len(ztid), np.uint8)))
        if not chunks:
            chunks.append((np.empty(0, np.int32), np.empty(0, np.uint32), np.empty(0, np.uint8)))
        total_docs = max((off + ix.num_docs for ix, off in zip(indexes, doc_offsets)), default=0)
        spans = sorted((off, off + ix.num_docs) for ix, off in zip(indexes, doc_offsets))
        overlap = any(b0 < a1 for (_, a1), (b0, _) in zip(spans, spans[1:]))
        return cls._finalize(vocab, chunks, num_docs=total_docs, max_doc=total_docs - 1,
                             check_dups=overlap)

    def filter_docs(self, keep_mask: np.ndarray) -> "InvertedIndexData":
        """Remove documents without a corpus rebuild (dedup, takedowns,
        re-sharding).  ``keep_mask`` is bool[num_docs]; surviving documents
        renumber compactly and terms left with no postings drop, so the
        result is byte-identical on save() to a one-shot build over the kept
        corpus.  O(postings) array work."""
        keep_mask = np.asarray(keep_mask, dtype=bool)
        if keep_mask.shape != (self.num_docs,):
            raise ValueError(f"mask shape {keep_mask.shape} != ({self.num_docs},)")
        new_id = np.cumsum(keep_mask, dtype=np.int64) - 1
        nvocab = len(self.vocab)

        def _filter(offsets, doc_ids, values=None):
            pk = keep_mask[doc_ids]
            term_of = np.repeat(np.arange(nvocab), np.diff(offsets))
            counts = np.bincount(term_of[pk], minlength=nvocab)
            out = np.zeros(nvocab + 1, np.int64)
            np.cumsum(counts, out=out[1:])
            docs = new_id[doc_ids[pk]].astype(np.uint32)
            return out, docs, (values[pk] if values is not None else None)

        offsets, doc_ids, impacts = _filter(self.offsets, self.doc_ids, self.impacts)
        zero_offsets, zero_doc_ids, _ = _filter(self.zero_offsets, self.zero_doc_ids)
        occurs = (np.diff(offsets) + np.diff(zero_offsets)) > 0
        if not occurs.all():
            vocab = [t for t, k in zip(self.vocab, occurs) if k]
            keep_plus = np.concatenate((np.flatnonzero(occurs), [nvocab]))
            offsets = offsets[keep_plus]
            zero_offsets = zero_offsets[keep_plus]
        else:
            vocab = list(self.vocab)
        return InvertedIndexData(
            vocab, offsets, doc_ids, impacts, num_docs=int(keep_mask.sum()),
            zero_offsets=zero_offsets, zero_doc_ids=zero_doc_ids,
        )

    def delete_docs(self, doc_ids: Sequence[int]) -> "InvertedIndexData":
        """``filter_docs`` convenience: drop the given doc ids."""
        keep = np.ones(self.num_docs, dtype=bool)
        keep[np.asarray(list(doc_ids), dtype=np.int64)] = False
        return self.filter_docs(keep)

    def split_docs(self, n_shards: int) -> List["InvertedIndexData"]:
        """Split into ``n_shards`` consecutive doc-range shards (bounds from
        ``np.linspace``) for the serving router (serve/router.py: shard i's
        doc-id offset is the doc count of shards 0..i-1).  Inverse of
        ``merge``: merging the shards back is byte-identical to this index.
        Cost: one full ``filter_docs`` pass per shard."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        bounds = np.linspace(0, self.num_docs, n_shards + 1).astype(np.int64)
        shards = []
        for i in range(n_shards):
            keep = np.zeros(self.num_docs, dtype=bool)
            keep[bounds[i] : bounds[i + 1]] = True
            shards.append(self.filter_docs(keep))
        return shards

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
