"""Corpus-scale query engine on the card: heavy terms as dense rows + tail
scatter + exact integer top-k.

Counterpart of ``improving_learned_index_tpu/search/hybrid_engine.py``, the
replacement for the reference's per-query Python postings loop
(src/deep_impact/inverted_index/inverted_index.py:55-62).

- **Heavy terms become dense rows.**  The longest posting lists, within
  ``dense_budget_bytes``, are materialized once at load as rows of a
  [T_heavy, n_pad] matrix on the card: bf16 (quantized impacts <= 255 and
  their sums <= 256 are exact there), fp32 when duplicate postings push a
  cell past 256.  A batch's heavy stage reads only the rows its queries hit
  (``ops.gather_rows``).
- **Tail terms keep gather + scatter-add.**  The chunk table of the tail
  posting ranges is expanded into flat (doc, impact, query) updates and
  added into the score matrix (``ops.scatter_scores``).
- **Exact top-k without sorting** (``ops.exact_topk``): boundary ties
  resolve in doc-id order.

On CUDA tensors the two stages always launch the hand-written kernels
(``csrc/``); on the CPU, and on the card with ``use_kernels=False`` (for
cross-checks only), they run the kernels' plain PyTorch versions.  The
TPU's shape gates (VMEM limits) and its XLA-only scatter regimes do not
carry over: the kernels take any batch, any hit-row count and bf16 or fp32
rows.  Batches are not split into 64-query sub-batches: the score matrix
costs nq x n_pad x 4 B (9 GB for 256 queries at 8.85M docs), which the
card's 80 GB holds, and neither kernel has a per-batch limit.

Not ported yet: float-impact mode (``integer_scores=False``,
``from_term_impacts``), the opt-in ``tail_partitioned`` layout and
approximate top-k.

The public contract matches the JAX engine: ``score_batch(term_sets, k)``
-> per query, a list of (doc_id, score) with score > 0, exact scores, exact
top-k in score order with ties in doc-id order.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.device import resolve_device
from ..index.inverted import InvertedIndexData
from ..ops import gather_rows, scatter_scores
from ..ops.exact_topk import _BLOCK, exact_topk_integer

TAIL_CHUNK = 512
# n_pad rule of the JAX engine: from this corpus size the doc axis pads to a
# whole number of 65536-doc tiles (<= 12.5% pad), below it to 128 docs.
_TILE = 1 << 16
_TILE_ALIGN_MIN_DOCS = 1 << 19
# rows per fp32 accumulation chunk of the dense build (1.1 GB at 8.85M docs)
_DENSE_CHUNK_ROWS = 32


def expand_tail_chunks(starts, ends, rows, chunk):
    """Vectorized per-term -> per-chunk table expansion.

    ``starts``/``ends``: int64 posting ranges per tail term; ``rows``: the
    query row each term belongs to.  Splits every range into windows of
    ``chunk`` postings and returns (chunk_starts, chunk_lengths, chunk_rows)
    as int32 arrays — the layout ``_gather_tail`` consumes."""
    n_chunks = -(-(ends - starts) // chunk)
    total = int(n_chunks.sum())
    if total == 0:
        e = np.empty(0, np.int32)
        return e, e.copy(), e.copy()
    firsts = np.zeros(len(starts) + 1, np.int64)
    np.cumsum(n_chunks, out=firsts[1:])
    term_of = np.repeat(np.arange(len(starts)), n_chunks)
    within = np.arange(total, dtype=np.int64) - firsts[term_of]
    cs = starts[term_of] + within * chunk
    cl = np.minimum(chunk, ends[term_of] - cs)
    return (
        cs.astype(np.int32),
        cl.astype(np.int32),
        rows[term_of].astype(np.int32),
    )


def build_dense_rows(
    doc_ids: torch.Tensor,
    impacts: torch.Tensor,
    heavy_starts: np.ndarray,
    t_heavy: int,
    n_pad: int,
) -> torch.Tensor:
    """Scatter-accumulate dense heavy rows [t_heavy, n_pad] on the device
    holding ``doc_ids``/``impacts``.

    ``doc_ids`` (int32) / ``impacts`` (any numeric type) hold the heavy
    postings in dense-row order; ``heavy_starts`` is the host-side
    [t_heavy + 1] row-boundary table.  Rows are accumulated in fp32, a
    ``_DENSE_CHUNK_ROWS`` x n_pad buffer at a time, so
    duplicate (term, doc) postings sum exactly like the scatter path; the
    rows are kept in bf16 only when every cell is <= 256, where bf16 is
    exact for 8-bit quantized impact sums, and are rebuilt in fp32
    otherwise."""
    dev = doc_ids.device
    p_heavy = int(heavy_starts[-1])
    if t_heavy == 0 or p_heavy == 0:
        return torch.zeros(max(t_heavy, 1), n_pad, dtype=torch.bfloat16, device=dev)
    if p_heavy >= 2**31:
        raise ValueError(f"int32 posting positions: {p_heavy} heavy postings")
    ch = min(_DENSE_CHUNK_ROWS, t_heavy)
    lens = torch.from_numpy(np.diff(heavy_starts)).to(dev)

    def build(dtype):
        dense = torch.empty(t_heavy, n_pad, dtype=dtype, device=dev)
        acc = torch.empty(ch * n_pad, dtype=torch.float32, device=dev)
        mx = torch.zeros((), dtype=torch.float32, device=dev)
        for r0 in range(0, t_heavy, ch):
            r1 = min(r0 + ch, t_heavy)
            s0, s1 = int(heavy_starts[r0]), int(heavy_starts[r1])
            acc.zero_()
            rows = torch.repeat_interleave(
                torch.arange(r1 - r0, device=dev), lens[r0:r1], output_size=s1 - s0
            )
            acc.index_add_(0, rows * n_pad + doc_ids[s0:s1].long(), impacts[s0:s1].float())
            block = acc[: (r1 - r0) * n_pad].view(r1 - r0, n_pad)
            mx = torch.maximum(mx, block.max())
            dense[r0:r1] = block
        return dense, mx

    dense, mx = build(torch.bfloat16)
    if float(mx) > 256:
        del dense
        dense, _ = build(torch.float32)
    return dense


def _gather_tail(doc_ids, impacts, starts, lengths, rows):
    """Expand the chunk table into flat (doc, value, row) update arrays.

    Each chunk reads TAIL_CHUNK contiguous positions from ``starts``; lanes
    past the chunk's length get value 0 (padding for the scatter).
    INVARIANT: ``doc_ids``/``impacts`` end in >= TAIL_CHUNK zeros (the engine
    pads at init), so a partial chunk at the array end never reads out of
    bounds."""
    offs = torch.arange(TAIL_CHUNK, dtype=torch.int32, device=starts.device)[None, :]
    pos = (starts[:, None] + offs).reshape(-1)
    valid = (offs < lengths[:, None]).reshape(-1)
    d = doc_ids.index_select(0, pos)
    v = torch.where(valid, impacts.index_select(0, pos), 0.0)
    r = rows[:, None].expand(-1, TAIL_CHUNK).reshape(-1)
    return d, v, r


def _finish_topk(scores: torch.Tensor, num_docs: int, k: int):
    """Exact integer top-k over the real docs.  When the padded width is a
    whole number of selection blocks the padding stays (its columns score
    0, and zero is never selected), which spares a copy of the matrix."""
    if scores.shape[1] % _BLOCK:
        scores = scores[:, :num_docs]
    return exact_topk_integer(scores, k)


class HybridSearchEngine:
    """Batched exact scoring over a quantized inverted index, corpus scale."""

    def __init__(
        self,
        index: InvertedIndexData,
        config: SearchConfig = SearchConfig(),
        heavy_min: int = 1024,
        dense_budget_bytes: int = 4 << 30,
        device: Optional[Union[str, torch.device]] = None,
        use_kernels: Optional[bool] = None,
    ):
        if config.approx_top_k:
            raise ValueError("approximate top-k is not ported; the port's top-k is exact")
        self.config = config
        self.device = resolve_device(device)
        if use_kernels and self.device.type != "cuda":
            raise ValueError("use_kernels=True needs a CUDA device")
        # None: the kernels on CUDA.  False on the card runs the plain
        # versions, for cross-checks only.
        self.use_kernels = self.device.type == "cuda" if use_kernels is None else bool(use_kernels)
        if self.use_kernels:
            self._accumulate_rows = gather_rows.accumulate_rows
            self._apply_tail_updates = scatter_scores.apply_tail_updates
        else:
            self._accumulate_rows = gather_rows.accumulate_rows_plain
            self._apply_tail_updates = scatter_scores.apply_tail_updates_plain
        self.vocab: Dict[str, int] = index.term_to_id
        self.num_docs = max(int(index.num_docs), 1)
        if self.num_docs >= 2**31:
            raise ValueError("doc ids must fit int32")
        if self.num_docs >= _TILE_ALIGN_MIN_DOCS:
            self.n_pad = -(-self.num_docs // _TILE) * _TILE
        else:
            self.n_pad = ((self.num_docs + 127) // 128) * 128
        offsets = np.asarray(index.offsets, dtype=np.int64)
        lengths = np.diff(offsets)

        # Pick heavy terms: longest lists first, bounded by the device
        # memory budget for the bf16 dense matrix.
        max_rows = max(1, dense_budget_bytes // (2 * self.n_pad))
        heavy_tids = np.nonzero(lengths >= heavy_min)[0]
        if len(heavy_tids) > max_rows:
            order = np.argsort(lengths[heavy_tids])[::-1]
            heavy_tids = np.sort(heavy_tids[order[:max_rows]])
        # term id -> dense row, -1 = tail
        self.heavy_row_arr = np.full(len(lengths), -1, dtype=np.int32)
        self.heavy_row_arr[heavy_tids] = np.arange(len(heavy_tids), dtype=np.int32)
        self.t_heavy = len(heavy_tids)
        is_heavy = np.zeros(len(lengths), dtype=bool)
        is_heavy[heavy_tids] = True
        self.is_heavy = is_heavy

        doc_ids = np.asarray(index.doc_ids, dtype=np.uint32)
        impacts = np.asarray(index.impacts, dtype=np.uint8)
        dev = self.device

        # Heavy postings go to the card only for the dense build, in
        # dense-row order; afterwards they live only in the dense rows.
        heavy_starts = np.zeros(self.t_heavy + 1, dtype=np.int64)
        np.cumsum(lengths[heavy_tids], out=heavy_starts[1:])
        if self.t_heavy:
            spans = [(offsets[t], offsets[t + 1]) for t in heavy_tids]
            h_docs = torch.from_numpy(
                np.concatenate([doc_ids[s:e] for s, e in spans]).view(np.int32)
            ).to(dev)
            h_vals = torch.from_numpy(np.concatenate([impacts[s:e] for s, e in spans])).to(dev)
            self.dense = build_dense_rows(h_docs, h_vals, heavy_starts, self.t_heavy, self.n_pad)
            del h_docs, h_vals
        else:
            self.dense = torch.zeros(1, self.n_pad, dtype=torch.bfloat16, device=dev)

        # Tail postings in term order; term_start is each term's position
        # among them (heavy terms: 0, dense-only, never gathered).  The
        # TAIL_CHUNK trailing zeros keep every chunk read in bounds.
        tail_len = np.where(is_heavy, 0, lengths)
        self.term_start = np.zeros(len(lengths), dtype=np.int64)
        np.cumsum(tail_len[:-1], out=self.term_start[1:])
        self.term_len = lengths
        if self.t_heavy:
            tail_mask = np.repeat(~is_heavy, lengths)
            t_docs, t_vals = doc_ids[tail_mask], impacts[tail_mask]
        else:
            t_docs, t_vals = doc_ids, impacts
        self.doc_ids = torch.from_numpy(
            np.concatenate([t_docs.view(np.int32), np.zeros(TAIL_CHUNK, np.int32)])
        ).to(dev)
        self.impacts = torch.from_numpy(
            np.concatenate([t_vals, np.zeros(TAIL_CHUNK, np.uint8)])
        ).to(dev).float()
        self._released = False

    def _tables(self, query_term_sets: Sequence[Set[str]]):
        """Host-side prep: heavy (query, dense row) incidences + tail chunk
        table.  The only Python-loop work is one dict lookup per query term;
        the per-term chunk expansion is numpy (``expand_tail_chunks``).

        Returns (heavy_q, heavy_rows, chunk_starts, chunk_lengths,
        chunk_rows); ``heavy_q`` ascends (pairs grouped by query)."""
        qs: List[int] = []
        tids: List[int] = []
        get = self.vocab.get
        for q, terms in enumerate(query_term_sets):
            for term in terms:
                tid = get(term)
                if tid is not None:
                    qs.append(q)
                    tids.append(tid)
        if not tids:
            e = np.empty(0, np.int32)
            return e, e.copy(), e.copy(), e.copy(), e.copy()
        q_arr = np.asarray(qs, dtype=np.int64)
        tid_arr = np.asarray(tids, dtype=np.int64)
        hrow = self.heavy_row_arr[tid_arr]
        heavy = hrow >= 0
        t_q, t_tid = q_arr[~heavy], tid_arr[~heavy]
        starts = self.term_start[t_tid]
        return (
            q_arr[heavy].astype(np.int32),
            hrow[heavy],
            *expand_tail_chunks(starts, starts + self.term_len[t_tid], t_q, TAIL_CHUNK),
        )

    def stage_inputs(self, query_term_sets: Sequence[Set[str]]):
        """One batch's inputs to the two scoring stages, on the engine's
        device: ``heavy`` = (ids, pairs, counts) for ``accumulate_rows``,
        ``tail`` = (d, v, r) for ``apply_tail_updates``; each is None when
        no query term falls in that stage."""
        heavy_q, heavy_rows, starts, lengths, rows = self._tables(query_term_sets)
        dev = self.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)

        heavy = tail = None
        if len(heavy_q):
            uniq, inv = np.unique(heavy_rows, return_inverse=True)
            heavy = (
                put(uniq),
                put(np.stack([heavy_q, inv.reshape(-1)], axis=1)),
                put([len(uniq), len(heavy_q)]),
            )
        if len(starts):
            tail = _gather_tail(self.doc_ids, self.impacts, put(starts), put(lengths), put(rows))
        return heavy, tail

    def warmup(self, max_batch: int = 64, top_k: Optional[int] = None) -> int:
        """Load the kernels and score one batch of ``max_batch`` queries,
        each the longest heavy term plus the longest tail term, so the first
        live batch pays no kernel build or allocator growth.  Returns the
        number of batches run."""
        lengths = self.term_len
        terms = []
        for mask in (self.is_heavy, ~self.is_heavy & (lengths > 0)):
            if mask.any():
                terms.append(int(np.nonzero(mask)[0][np.argmax(lengths[mask])]))
        if not terms:
            return 0
        id_to_term = {i: t for t, i in self.vocab.items()}
        query = {id_to_term[t] for t in terms}
        self.score_batch([query] * max_batch, top_k)
        return 1

    def release(self) -> None:
        """Free the engine's device buffers (dense heavy rows + tail posting
        arrays) ahead of a swap; new score calls raise.  Idempotent."""
        self._released = True
        self.dense = None
        self.doc_ids = None
        self.impacts = None

    def score_batch_async(
        self,
        query_term_sets: Sequence[Set[str]],
        top_k: Optional[int] = None,
    ):
        """Launch a batch and return a zero-arg finalizer.

        The result copy to the host is asynchronous: launch batch i+1 before
        finalizing batch i and the host prep of one overlaps the device work
        of the other.  (The top-k's convergence test still reads a flag back
        per search pass.)
        """
        if self._released:
            raise RuntimeError("engine released")
        if top_k is None:
            top_k = self.config.top_k
        nq = len(query_term_sets)
        if nq == 0:
            return lambda: []
        k = min(top_k, self.num_docs)
        heavy, tail = self.stage_inputs(query_term_sets)
        if heavy is None and tail is None:
            return lambda: [[] for _ in range(nq)]
        dev = self.device
        if heavy is not None:
            scores = self._accumulate_rows(self.dense, *heavy, nq)
        else:
            scores = torch.zeros(nq, self.n_pad, dtype=torch.float32, device=dev)
        if tail is not None:
            scores = self._apply_tail_updates(scores, *tail)
        vals, idx = _finish_topk(scores, self.num_docs, k)
        del scores
        # one host copy per batch: [nq, 2, k] int32 (scores bit-cast)
        packed = torch.stack([vals.view(torch.int32), idx], dim=1)
        if dev.type == "cuda":
            host = packed.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = packed, None

        def finalize() -> List[List[Tuple[int, float]]]:
            if done is not None:
                done.synchronize()
            h = host.numpy()
            top_scores = h[:, 0].view(np.float32)
            top_docs = h[:, 1]
            n_pos = (top_scores > 0).sum(axis=1)  # scores descend: a prefix
            return [
                list(zip(top_docs[i, : n_pos[i]].tolist(), top_scores[i, : n_pos[i]].tolist()))
                for i in range(nq)
            ]

        return finalize

    def score_batch(
        self,
        query_term_sets: Sequence[Set[str]],
        top_k: Optional[int] = None,
    ) -> List[List[Tuple[int, float]]]:
        return self.score_batch_async(query_term_sets, top_k)()

    def score_stream(self, query_batches, top_k: Optional[int] = None, depth: int = 2):
        """Pipelined scoring of an iterable of query batches: keeps ``depth``
        batches in flight so host work overlaps device work."""
        pending = deque()
        for batch in query_batches:
            pending.append(self.score_batch_async(batch, top_k))
            if len(pending) > depth:
                yield pending.popleft()()
        while pending:
            yield pending.popleft()()
