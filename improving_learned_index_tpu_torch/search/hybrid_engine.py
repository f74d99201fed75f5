"""Corpus-scale query engine on the card: heavy terms as dense rows + tail
scatter + exact top-k.

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
  posting ranges goes to the card, and ``ops.scatter_scores.apply_tail_chunks``
  reads it and the tail postings in place and adds them into the score
  matrix.
- **Exact top-k without sorting** (``ops.exact_topk``): boundary ties
  resolve in doc-id order.  Each batch hands it a bound on its scores
  (``score_bound``: the most one term adds to one doc, times the longest
  query's term count), so the k-th scores come from a value histogram on
  the card (``ops.topk_select``) with no host read; a batch whose bound
  reaches ``topk_select.BINS`` takes the n-ary search (``ops.count_ge``).
- **Float mode** (``integer_scores=False``, built by ``from_term_impacts``
  from encoder output: SparseSearch's in-memory index of large eval
  corpora).  Impacts stay fp32 from the posting arrays through the dense
  rows (always fp32: float impacts are never bf16-exact) and the tail, and
  the top-k is a stable descending sort, ``jax.lax.top_k``'s order (the
  lower doc id first among ties): the threshold search of
  ``exact_topk_integer`` needs an integer score lattice.  Float sums depend
  on the order of the adds in the last ulps; the kernels add in another
  order than XLA does.

On CUDA tensors the two stages and the top-k's passes always launch the
hand-written kernels (``csrc/``); on the CPU, and on the card inside
``ops.plain_versions()`` (for cross-checks only), they run the kernels'
plain PyTorch versions.  The TPU's shape gates (VMEM limits) and its XLA-only scatter regimes do not
carry over: the kernels take any batch, any hit-row count and bf16 or fp32
rows.  Batches are not split into 64-query sub-batches: the score matrix
costs nq x n_pad x 4 B (9 GB for 256 queries at 8.85M docs), which the
card's 80 GB holds, and neither kernel has a per-batch limit.

Not ported: the opt-in ``tail_partitioned`` layout (it lost its own A/B in
the JAX package) and approximate top-k.

The public contract matches the JAX engine: ``score_batch(term_sets, k)``
-> per query, a list of (doc_id, score) with score > 0, exact scores, exact
top-k in score order with ties in doc-id order.
"""

from __future__ import annotations

from collections import deque
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.device import device_scope, resolve_device
from ..core.profiling import annotate
from ..index.inverted import InvertedIndexData
from ..ops import gather_rows, scatter_scores
from ..ops.exact_topk import _BLOCK, exact_topk_integer

_REPEAT_CHUNK = 1 << 25  # postings a sort of ``max_repeats`` (~1.5 GB of temporaries)

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
    as int32 arrays — the layout ``ops.scatter_scores.apply_tail_chunks``
    consumes."""
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
    force_fp32: bool = False,
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
    otherwise.  ``force_fp32`` builds fp32 rows directly: non-integer float
    impacts are never bf16-exact."""
    dev = doc_ids.device
    p_heavy = int(heavy_starts[-1])
    if t_heavy == 0 or p_heavy == 0:
        dtype = torch.float32 if force_fp32 else torch.bfloat16
        return torch.zeros(max(t_heavy, 1), n_pad, dtype=dtype, device=dev)
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

    if force_fp32:
        return build(torch.float32)[0]
    dense, mx = build(torch.bfloat16)
    if float(mx) > 256:
        del dense
        dense, _ = build(torch.float32)
    return dense


def max_repeats(doc_ids: torch.Tensor, lengths: np.ndarray, chunk: int = _REPEAT_CHUNK) -> int:
    """The most times one list holds one doc, over the lists laid end to
    end in ``doc_ids`` (int32, on any device) with ``lengths``: 1 for lists
    of distinct docs, 0 for no postings.  The lists are sorted on their
    device, about ``chunk`` postings at a time (a longer list alone)."""
    ends = np.cumsum(lengths)
    dev = doc_ids.device
    most, t0, p0 = 0, 0, 0
    while t0 < len(lengths):
        t1 = max(t0 + 1, int(np.searchsorted(ends, p0 + chunk, side="right")))
        p1 = int(ends[t1 - 1])
        if p1 > p0:
            lens = torch.from_numpy(np.asarray(lengths[t0:t1], dtype=np.int64)).to(dev)
            lists = torch.repeat_interleave(torch.arange(t1 - t0, device=dev), lens, output_size=p1 - p0)
            keys = torch.sort((lists << 32) | doc_ids[p0:p1].long()).values
            most = max(most, int(torch.unique_consecutive(keys, return_counts=True)[1].max()))
        t0, p0 = t1, p1
    return most


def padded_width(num_docs: int) -> int:
    """The doc axis's padded width: whole 65536-doc tiles from 2**19 docs,
    else a multiple of 128 (the JAX engines' rule)."""
    if num_docs >= _TILE_ALIGN_MIN_DOCS:
        return -(-num_docs // _TILE) * _TILE
    return ((num_docs + 127) // 128) * 128


def pick_heavy_terms(lengths: np.ndarray, heavy_min: int, dense_budget_bytes: int, n_pad: int) -> np.ndarray:
    """The dense rows' term ids, ascending: lists of at least ``heavy_min``
    postings, longest first within ``dense_budget_bytes`` of bf16 rows
    [T_heavy, n_pad] (the JAX engines' rule, in both score modes)."""
    max_rows = max(1, dense_budget_bytes // (2 * n_pad))
    heavy_tids = np.nonzero(lengths >= heavy_min)[0]
    if len(heavy_tids) > max_rows:
        order = np.argsort(lengths[heavy_tids])[::-1]
        heavy_tids = np.sort(heavy_tids[order[:max_rows]])
    return heavy_tids


def lookup_terms(vocab: Dict[str, int], query_term_sets: Sequence[Set[str]]):
    """Each known (query, term id) incidence as two int64 arrays; the only
    Python loop of a batch's host prep is this one dict lookup a term."""
    qs: List[int] = []
    tids: List[int] = []
    get = vocab.get
    for q, terms in enumerate(query_term_sets):
        for term in terms:
            tid = get(term)
            if tid is not None:
                qs.append(q)
                tids.append(tid)
    return np.asarray(qs, dtype=np.int64), np.asarray(tids, dtype=np.int64)


def split_terms(vocab: Dict[str, int], heavy_row_arr: np.ndarray, query_term_sets: Sequence[Set[str]]):
    """A batch's known (query, term) incidences split by stage: (heavy
    query rows (int32), their dense rows, tail query rows, tail term ids)."""
    q_arr, tid_arr = lookup_terms(vocab, query_term_sets)
    hrow = heavy_row_arr[tid_arr]
    heavy = hrow >= 0
    return q_arr[heavy].astype(np.int32), hrow[heavy], q_arr[~heavy], tid_arr[~heavy]


def put_int32(a, device: torch.device) -> torch.Tensor:
    """A host array as a contiguous int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def topk_to_host(vals: torch.Tensor, idx: torch.Tensor, device: torch.device):
    """Start one host copy of a batch's top-k, [nq, 2, k] int32 (scores
    bit-cast), and return its zero-arg finalizer: per query, the (doc id,
    score) pairs with score > 0.  Call it under ``device_scope(device)``.
    The finalizer's wait for the copy is the region ``search/result_wait``,
    its building of the answers ``search/answers``."""
    packed = torch.stack([vals.view(torch.int32), idx], dim=1)
    if device.type == "cuda":
        host = packed.to("cpu", non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
    else:
        host, done = packed, None

    def finalize() -> List[List[Tuple[int, float]]]:
        with annotate("search/result_wait"):
            if done is not None:
                done.synchronize()
        with annotate("search/answers"):
            h = host.numpy()
            top_scores = h[:, 0].view(np.float32)
            top_docs = h[:, 1]
            n_pos = (top_scores > 0).sum(axis=1)  # scores descend: a prefix
            return [
                list(zip(top_docs[i, : n_pos[i]].tolist(), top_scores[i, : n_pos[i]].tolist()))
                for i in range(len(h))
            ]

    return finalize


def _finish_topk(scores: torch.Tensor, num_docs: int, k: int, integer_scores: bool,
                 max_score: Optional[float] = None):
    """Exact top-k over the real docs, (values, int32 doc ids).

    Integer scores: ``exact_topk_integer``; when the padded width is a whole
    number of selection blocks the padding stays (its columns score 0, and
    zero is never selected), which spares a copy of the matrix;
    ``max_score`` is the caller's bound on the scores.  Float
    scores: the padding is dropped and a stable descending sort takes the
    first k, the lower doc id first among ties.  The whole is the region
    ``search/topk``; ``exact_topk_integer`` is looked up at call time."""
    with annotate("search/topk"):
        if not integer_scores:
            vals, idx = torch.sort(scores[:, :num_docs], dim=1, descending=True, stable=True)
            return vals[:, :k], idx[:, :k].to(torch.int32)
        if scores.shape[1] % _BLOCK:
            scores = scores[:, :num_docs]
        return exact_topk_integer(scores, k, max_score=max_score)


class HybridSearchEngine:
    """Batched exact scoring over an inverted index, corpus scale.

    ``integer_scores``: True for quantized indexes (integer impact sums,
    bf16 rows where exact, ``exact_topk_integer``); False for float impacts
    (fp32 postings and rows, sort-based top-k).  Heavy rows are picked by the
    JAX engine's rule in both modes, ``dense_budget_bytes`` over 2 bytes a
    cell, so both packages pick the same rows; fp32 rows can then take up to
    twice ``dense_budget_bytes``."""

    def __init__(
        self,
        index: InvertedIndexData,
        config: SearchConfig = SearchConfig(),
        heavy_min: int = 1024,
        dense_budget_bytes: int = 4 << 30,
        integer_scores: bool = True,
        device: Optional[Union[str, torch.device]] = None,
        heavy_terms: Optional[np.ndarray] = None,
    ):
        """``heavy_terms``: the dense rows' term ids, ascending, in place of
        the pick by ``heavy_min`` and ``dense_budget_bytes`` (a doc shard of
        ``ShardedSearchEngine`` takes the pick made on the global lists)."""
        if config.approx_top_k:
            raise ValueError("approximate top-k is not ported; the port's top-k is exact")
        self.config = config
        self.integer_scores = integer_scores
        self.device = resolve_device(device)
        self.vocab: Dict[str, int] = index.term_to_id
        self.num_docs = max(int(index.num_docs), 1)
        if self.num_docs >= 2**31:
            raise ValueError("doc ids must fit int32")
        self.n_pad = padded_width(self.num_docs)
        offsets = np.asarray(index.offsets, dtype=np.int64)
        lengths = np.diff(offsets)
        if heavy_terms is None:
            heavy_tids = pick_heavy_terms(lengths, heavy_min, dense_budget_bytes, self.n_pad)
        else:
            heavy_tids = np.asarray(heavy_terms, dtype=np.int64)
        # term id -> dense row, -1 = tail
        self.heavy_row_arr = np.full(len(lengths), -1, dtype=np.int32)
        self.heavy_row_arr[heavy_tids] = np.arange(len(heavy_tids), dtype=np.int32)
        self.t_heavy = len(heavy_tids)
        is_heavy = np.zeros(len(lengths), dtype=bool)
        is_heavy[heavy_tids] = True
        self.is_heavy = is_heavy

        doc_ids = np.asarray(index.doc_ids, dtype=np.uint32)
        impacts = np.asarray(index.impacts, dtype=np.uint8 if integer_scores else np.float32)
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
            self.dense = build_dense_rows(h_docs, h_vals, heavy_starts, self.t_heavy, self.n_pad,
                                          force_fp32=not integer_scores)
            del h_docs, h_vals
        else:
            self.dense = torch.zeros(1, self.n_pad, device=dev,
                                     dtype=torch.bfloat16 if integer_scores else torch.float32)

        # Tail postings in term order; term_start is each term's position
        # among them (heavy terms: 0, dense-only, never gathered).
        tail_len = np.where(is_heavy, 0, lengths)
        self.term_start = np.zeros(len(lengths), dtype=np.int64)
        np.cumsum(tail_len[:-1], out=self.term_start[1:])
        self.term_len = lengths
        if self.t_heavy:
            tail_mask = np.repeat(~is_heavy, lengths)
            t_docs, t_vals = doc_ids[tail_mask], impacts[tail_mask]
        else:
            t_docs, t_vals = doc_ids, impacts
        self.doc_ids = torch.from_numpy(t_docs.astype(np.int32)).to(dev)
        self.impacts = torch.from_numpy(np.ascontiguousarray(t_vals)).to(dev).float()
        # the most one term adds to one doc's score: a dense row's largest
        # cell, or the largest tail impact times the most postings a tail
        # list holds for one doc; None for float scores (no bound is needed)
        self.term_score_max = None
        if integer_scores:
            heavy_max = float(self.dense.max()) if self.t_heavy else 0.0
            tail_max = float(self.impacts.max()) * max_repeats(self.doc_ids, tail_len) if len(t_docs) else 0.0
            self.term_score_max = max(heavy_max, tail_max)
        self._released = False

    @classmethod
    def from_term_impacts(
        cls,
        per_doc_impacts,  # iterable of [(term, float score), ...] per doc
        config: SearchConfig = SearchConfig(),
        heavy_min: int = 1024,
        dense_budget_bytes: int = 4 << 30,
        device: Optional[Union[str, torch.device]] = None,
    ) -> "HybridSearchEngine":
        """In-memory float-impact engine straight from encoder output (the
        reference SparseSearch index semantics, nano_beir_evaluator.py:78-101:
        keep score > 0, no quantization), for eval corpora too large for the
        device engine's flat [Q, num_docs] scatter."""
        from .device_engine import csr_from_term_impacts

        vocab, offsets, doc_ids, impacts, n_docs = csr_from_term_impacts(per_doc_impacts)
        index = SimpleNamespace(term_to_id=vocab, offsets=offsets, doc_ids=doc_ids,
                                impacts=impacts, num_docs=n_docs)
        return cls(index, config, heavy_min=heavy_min, dense_budget_bytes=dense_budget_bytes,
                   integer_scores=False, device=device)

    def tail_chunks(self, t_q: np.ndarray, t_tid: np.ndarray):
        """The chunk table (starts, lengths, rows) of the tail terms
        ``t_tid`` of query rows ``t_q``: TAIL_CHUNK windows into
        ``doc_ids``/``impacts`` (``expand_tail_chunks``)."""
        starts = self.term_start[t_tid]
        return expand_tail_chunks(starts, starts + self.term_len[t_tid], t_q, TAIL_CHUNK)

    def tail_input(self, t_q: np.ndarray, t_tid: np.ndarray):
        """``tail_chunks`` uploaded to the engine's device, or None when
        there is no tail term."""
        chunks = self.tail_chunks(t_q, t_tid)
        return tuple(put_int32(a, self.device) for a in chunks) if len(chunks[0]) else None

    def _tables(self, query_term_sets: Sequence[Set[str]]):
        """Host-side prep: (heavy_q, heavy_rows, chunk_starts,
        chunk_lengths, chunk_rows), each heavy pair's query and dense row,
        then the tail's chunk table."""
        heavy_q, heavy_rows, t_q, t_tid = split_terms(self.vocab, self.heavy_row_arr, query_term_sets)
        return (heavy_q, heavy_rows, *self.tail_chunks(t_q, t_tid))

    def stage_inputs(self, query_term_sets: Sequence[Set[str]]):
        """One batch's inputs to the two scoring stages, on the engine's
        device: ``heavy`` = the pair table for ``accumulate_grouped``
        (``gather_rows.group_pairs``, one upload), ``tail`` = the chunk
        table (starts, lengths, rows) of TAIL_CHUNK windows into
        ``doc_ids``/``impacts`` for ``apply_tail_chunks``; each is None when
        no query term falls in that stage.  The region ``search/stage_inputs``."""
        with annotate("search/stage_inputs"):
            heavy_q, heavy_rows, t_q, t_tid = split_terms(self.vocab, self.heavy_row_arr, query_term_sets)
            heavy = None
            if len(heavy_q):
                table = gather_rows.group_pairs(heavy_q, heavy_rows, len(query_term_sets))
                heavy = put_int32(table, self.device)
            return heavy, self.tail_input(t_q, t_tid)

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

    def score_bound(self, query_term_sets: Sequence[Set[str]]) -> Optional[float]:
        """A bound on every score of a (non-empty) batch: ``term_score_max``
        for each term of its longest query (an unknown term adds nothing);
        None for float scores."""
        if self.term_score_max is None:
            return None
        return self.term_score_max * max(map(len, query_term_sets))

    def topk_from_stages(self, heavy, tail, nq: int, k: int, max_score: Optional[float] = None):
        """The batch's exact top-k (values, int32 doc ids), [nq, k], from
        its staged inputs (``stage_inputs``; at least one not None): the
        heavy stage, the tail stage, the top-k, which takes the batch's
        ``score_bound`` as ``max_score``.  Call it under
        ``device_scope(self.device)``."""
        if heavy is not None:
            scores = gather_rows.accumulate_grouped(self.dense, heavy, nq)
        else:
            scores = torch.zeros(nq, self.n_pad, dtype=torch.float32, device=self.device)
        if tail is not None:
            scores = scatter_scores.apply_tail_chunks(scores, self.doc_ids, self.impacts, *tail, TAIL_CHUNK)
        return _finish_topk(scores, self.num_docs, k, self.integer_scores, max_score)

    def score_batch_async(
        self,
        query_term_sets: Sequence[Set[str]],
        top_k: Optional[int] = None,
    ):
        """Launch a batch and return a zero-arg finalizer.

        The result copy to the host is asynchronous: launch batch i+1 before
        finalizing batch i and the host prep of one overlaps the device work
        of the other.  (Only a batch whose ``score_bound`` reaches
        ``topk_select.BINS`` reads flags back: the n-ary search's, one a
        pass.)
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
        # the engine's own device, not the calling thread's current one (a
        # serving daemon's batch thread calls this)
        with device_scope(self.device):
            top = self.topk_from_stages(heavy, tail, nq, k, max_score=self.score_bound(query_term_sets))
            return topk_to_host(*top, self.device)

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
