"""Blocked term-at-a-time scoring (heavy lists) + gather/scatter tail, and
the engine around it, ``PallasBlockedEngine``.

Counterpart of ``improving_learned_index_tpu/ops/pallas_scoring.py``; the
module and class keep their names so a reader finds the counterpart.  The
JAX package keeps this engine as a tested alternative to the hybrid engine,
not its production path, and so does the port.

- Postings are re-sorted by (term, doc) so a (term, doc-block) subrange is
  contiguous; chunk windows start 128-aligned with [lo, hi) row masks (the
  JAX table format, kept so the two can be compared array for array).
- **Heavy** lists (>= ``HEAVY_MIN`` postings) go through ``blocked_scores``:
  one [8, 4096] fp32 tile per (8-query group, 4096-doc block) cell, summed
  from the cell's chunk windows.  Where ``_kernels.launches`` says so (CUDA
  tensors) it launches the hand-written kernel ``csrc/blocked_scoring.cu``
  (shared-memory atomics in place of the TPU's one-hot MXU product), and
  otherwise runs the plain version; there is no fallback from one to the
  other.
- **Tail** lists are cut into ``TAIL_CHUNK`` windows and added with
  ``ops.scatter_scores.apply_tail_chunks``, which reads the windows in
  place.
- The top-k is ``ops.exact_topk.exact_topk_integer`` (its search passes
  through ``ops.count_ge``): quantized impacts give integer sums, and after
  the ``s > 0`` filter its order (score desc, doc asc) is ``lax.top_k``'s.

Unlike the JAX engine, ``approx_top_k`` defaults to False and raises when
True (the port's top-k is exact), and ``interpret`` has no meaning here and
is dropped: the device of the engine picks the kernel or the plain version.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.device import resolve_device
from . import scatter_scores
from ._kernels import CudaKernel, launches, stream
from .exact_topk import exact_topk_integer

BLK = 4096  # docs per block (multiple of 128)
CH = 1024  # postings per window
QG = 8  # queries per cell
HEAVY_MIN = 4096  # lists shorter than this go to the tail path
TAIL_CHUNK = 1024
_ALIGN = 128  # window starts (the TPU's HBM slicing granule, kept for the table format)
_PLAIN_UPDATES = 1 << 24  # window positions the plain version expands at a time

KERNEL = CudaKernel(
    "blocked_scoring",
    {"ili_blocked_scoring": [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]},
)


def _check(cell_offsets, chunk_starts, chunk_meta, docs, vals, num_queries, num_blocks):
    if num_queries % QG:
        raise ValueError(f"num_queries must be a multiple of {QG}, got {num_queries}")
    if cell_offsets.shape != ((num_queries // QG) * num_blocks + 1,):
        raise ValueError("cell_offsets must hold one entry per (group, block) cell plus one")
    if chunk_starts.shape != chunk_meta.shape or chunk_starts.dim() != 1:
        raise ValueError("chunk_starts and chunk_meta must be flat arrays of one length")
    for name, t in (("cell_offsets", cell_offsets), ("chunk_starts", chunk_starts),
                    ("chunk_meta", chunk_meta), ("docs", docs)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if vals.dtype != torch.float32 or vals.shape != docs.shape:
        raise ValueError("vals must be fp32 and shaped as docs")
    for name, t in (("cell_offsets", cell_offsets), ("chunk_starts", chunk_starts),
                    ("chunk_meta", chunk_meta), ("vals", vals)):
        if t.device != docs.device:
            raise ValueError(f"{name} on {t.device}, docs on {docs.device}")


def window_postings(cell_offsets, chunk_starts, chunk_meta, docs, vals, num_blocks: int):
    """The postings the chunk windows add, as (linear index into the
    [queries, num_blocks * BLK] scores int64, impact fp32) pairs: each
    chunk's window positions in [lo, hi) whose doc lies in the cell's block
    (so never padding), yielded a slice of the chunk table at a time."""
    dev = docs.device
    n_chunks = int(cell_offsets[-1])
    if n_chunks == 0:
        return
    docs, vals = docs.reshape(-1), vals.reshape(-1)
    cell = torch.repeat_interleave(
        torch.arange(cell_offsets.numel() - 1, device=dev),
        (cell_offsets[1:] - cell_offsets[:-1]).long(), output_size=n_chunks,
    )
    meta = chunk_meta[:n_chunks].long()
    row = (cell // num_blocks) * QG + (meta >> 28)
    base = (cell % num_blocks) * BLK
    lo, hi = (meta >> 14) & 0x3FFF, meta & 0x3FFF
    offs = torch.arange(CH, device=dev)
    per = max(1, _PLAIN_UPDATES // CH)
    for c0 in range(0, n_chunks, per):
        sl = slice(c0, c0 + per)
        keep = (offs >= lo[sl, None]) & (offs < hi[sl, None])
        pos = torch.where(keep, chunk_starts[sl].long()[:, None] + offs, 0)
        d = docs[pos].long()
        local = d - base[sl, None]
        keep &= (d >= 0) & (local >= 0) & (local < BLK)
        yield (row[sl, None] * (num_blocks * BLK) + d)[keep], vals[pos][keep]


def blocked_scores_plain(cell_offsets, chunk_starts, chunk_meta, docs, vals,
                         num_queries: int, num_blocks: int) -> torch.Tensor:
    """Plain PyTorch version: ``index_put_(accumulate=True)`` of every
    chunk's masked window postings (``window_postings``) into
    [num_queries, num_blocks * BLK].  Only the kept lanes go in: masked
    lanes sent to one cell would form one long run of equal indices, which
    ``index_put_`` adds serially."""
    _check(cell_offsets, chunk_starts, chunk_meta, docs, vals, num_queries, num_blocks)
    out = torch.zeros(num_queries, num_blocks * BLK, dtype=torch.float32, device=docs.device)
    flat = out.view(-1)
    for lin, v in window_postings(cell_offsets, chunk_starts, chunk_meta, docs, vals, num_blocks):
        flat.index_put_((lin,), v, accumulate=True)
    return out


def blocked_scores(cell_offsets, chunk_starts, chunk_meta, docs, vals,
                   num_queries: int, num_blocks: int) -> torch.Tensor:
    """[num_queries, num_blocks * BLK] fp32: each (group, block) cell's tile
    is the sum of its chunk windows' postings.

    ``cell_offsets``: [groups * num_blocks + 1] int32 chunk range of each
    cell; ``chunk_starts`` / ``chunk_meta``: int32 window starts (into
    ``docs``/``vals``) and ``(qi << 28) | (lo << 14) | hi``; ``docs`` int32
    (-1 = padding) and ``vals`` fp32, each window start + CH in bounds.
    """
    if not launches(docs):
        return blocked_scores_plain(cell_offsets, chunk_starts, chunk_meta, docs, vals,
                                    num_queries, num_blocks)
    _check(cell_offsets, chunk_starts, chunk_meta, docs, vals, num_queries, num_blocks)
    for name, t in (("cell_offsets", cell_offsets), ("chunk_starts", chunk_starts),
                    ("chunk_meta", chunk_meta), ("docs", docs), ("vals", vals)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    out = torch.empty(num_queries, num_blocks * BLK, dtype=torch.float32, device=docs.device)
    if num_queries == 0 or num_blocks == 0:
        return out
    KERNEL.call(
        "ili_blocked_scoring",
        cell_offsets.data_ptr(), chunk_starts.data_ptr(), chunk_meta.data_ptr(),
        docs.data_ptr(), vals.data_ptr(), out.data_ptr(), num_queries // QG, num_blocks,
        stream(docs), device=docs.device,
    )
    return out


class PallasBlockedEngine:
    """Query scoring over doc-sorted postings: the blocked kernel (heavy
    lists) + the tail scatter, exact integer top-k.  Quantized (integer)
    impacts only."""

    def __init__(
        self,
        index,
        approx_top_k: bool = False,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if approx_top_k:
            raise ValueError("approximate top-k is not ported; the port's top-k is exact")
        self.approx_top_k = False
        self.device = dev = resolve_device(device)
        self.vocab = index.term_to_id
        self.num_docs = max(int(index.num_docs), 1)
        if self.num_docs >= 2**31:
            raise ValueError("doc ids must fit int32")
        self.num_blocks = -(-self.num_docs // BLK)

        offsets = np.asarray(index.offsets, dtype=np.int64)
        self.offsets = offsets
        n = int(offsets[-1])
        # (term, doc) order, duplicates in index order (np.lexsort's), by a
        # stable sort of term << 32 | doc on the device
        lengths = torch.from_numpy(np.diff(offsets)).to(dev)
        key = torch.repeat_interleave(
            torch.arange(len(offsets) - 1, device=dev), lengths, output_size=n
        ) << 32
        doc = torch.from_numpy(np.asarray(index.doc_ids).astype(np.int32, copy=False)).to(dev)
        key |= doc.long()
        order = torch.sort(key, stable=True).indices
        del key
        # aligned windows never run off the end; pad to 128 multiple + CH
        p_pad = ((n + _ALIGN - 1) // _ALIGN) * _ALIGN + CH
        self.docs = torch.full((1, p_pad), -1, dtype=torch.int32, device=dev)
        self.vals = torch.zeros(1, p_pad, dtype=torch.float32, device=dev)
        self.docs[0, :n] = doc[order]
        del doc
        impacts = torch.from_numpy(np.asarray(index.impacts)).to(dev)
        self.vals[0, :n] = impacts[order].float()
        del impacts, order
        self.docs_host = self.docs[0, :n].cpu().numpy()
        self._released = False

    def _tables(self, query_term_sets):
        """Host-side tables of one padded batch (len % QG == 0), as the JAX
        engine's: (cell_offsets, chunk_starts, chunk_lohi, tail [3, CT]).

        Within a cell the chunks keep the JAX loop's order: query ascending,
        then the terms in the set's iteration order, then window.  An empty
        block whose start is not 128-aligned still gets its zero-width
        chunk (lo == hi), as there."""
        nq = len(query_term_sets)
        nb = self.num_blocks
        n_groups = nq // QG
        heavy, tail = ([], [], []), ([], [], [])
        get = self.vocab.get
        for q, terms in enumerate(query_term_sets):
            for term in terms:
                tid = get(term)
                if tid is None:
                    continue
                s, e = int(self.offsets[tid]), int(self.offsets[tid + 1])
                if s == e:
                    continue
                for lst, x in zip(heavy if e - s >= HEAVY_MIN else tail, (q, s, e)):
                    lst.append(x)

        if tail[0]:
            from ..search.hybrid_engine import expand_tail_chunks

            t_q, t_s, t_e = (np.asarray(a, np.int64) for a in tail)
            t_table = np.stack(expand_tail_chunks(t_s, t_e, t_q, TAIL_CHUNK))
        else:
            t_table = np.zeros((3, 1), np.int32)

        cell_offsets = np.zeros(n_groups * nb + 1, dtype=np.int32)
        if not heavy[0]:
            return cell_offsets, np.zeros(1, np.int32), np.zeros(1, np.int32), t_table
        h_q = np.asarray(heavy[0], np.int64)
        # in the postings' own int32 (a wider key would copy each list to
        # convert it); the last edge clipped, above every doc id
        edges = np.minimum(np.arange(nb + 1, dtype=np.int64) * BLK, 2**31 - 1).astype(np.int32)
        bounds = np.stack([
            s + np.searchsorted(self.docs_host[s:e], edges) for s, e in zip(heavy[1], heavy[2])
        ])  # [pairs, nb + 1]: each block's posting range
        cs, ce = bounds[:, :-1].ravel(), bounds[:, 1:].ravel()  # pair-major, then block
        a0 = (cs // _ALIGN) * _ALIGN
        n_w = np.maximum(0, -(-(ce - a0) // CH))  # windows while start < ce
        pb = np.repeat(np.arange(len(cs)), n_w)
        first = np.cumsum(n_w) - n_w
        astart = a0[pb] + (np.arange(len(pb)) - first[pb]) * CH
        lo = np.maximum(cs[pb], astart) - astart
        hi = np.minimum(ce[pb], astart + CH) - astart
        q = h_q[pb // nb]
        cell = (q // QG) * nb + pb % nb
        meta = ((q % QG) << 28) | (lo << 14) | hi
        order = np.argsort(cell, kind="stable")  # keeps pair, then window order
        np.cumsum(np.bincount(cell, minlength=n_groups * nb), out=cell_offsets[1:])
        if not len(order):
            return cell_offsets, np.zeros(1, np.int32), np.zeros(1, np.int32), t_table
        return (
            cell_offsets,
            astart[order].astype(np.int32),
            meta[order].astype(np.int32),
            t_table,
        )

    def release(self) -> None:
        """Free the engine's device buffers; new score calls raise."""
        self._released = True
        self.docs = self.vals = None

    def score_batch(
        self, query_term_sets: Sequence[Set[str]], top_k: int = 1000
    ) -> List[List[Tuple[int, float]]]:
        if self._released:
            raise RuntimeError("engine released")
        nq = len(query_term_sets)
        if nq == 0:
            return []
        padded = list(query_term_sets) + [set()] * (-nq % QG)
        cell_offsets, chunk_starts, chunk_lohi, tail = self._tables(padded)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

        if cell_offsets[-1] > 0:
            scores = blocked_scores(
                put(cell_offsets), put(chunk_starts), put(chunk_lohi), self.docs, self.vals,
                len(padded), self.num_blocks,
            )
        else:
            scores = torch.zeros(len(padded), self.num_blocks * BLK, dtype=torch.float32, device=dev)
        if tail[1].any():
            scores = scatter_scores.apply_tail_chunks(scores, self.docs[0], self.vals[0], *put(tail), TAIL_CHUNK)
        # the padded columns (>= num_docs) score 0 and are never selected
        vals, idx = exact_topk_integer(scores, min(top_k, self.num_docs))
        del scores
        ts, td = vals[:nq].cpu().numpy(), idx[:nq].cpu().numpy()
        n_pos = (ts > 0).sum(axis=1)  # scores descend: a prefix
        return [
            list(zip(td[i, : n_pos[i]].tolist(), ts[i, : n_pos[i]].tolist()))
            for i in range(nq)
        ]
