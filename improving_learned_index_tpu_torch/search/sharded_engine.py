"""Doc-sharded query scoring over a list of devices.

Counterpart of ``improving_learned_index_tpu/search/sharded_engine.py``,
which scales the hybrid engine past one chip's memory: the dense heavy rows
and the tail postings are split by **document range**, each shard scores its
docs with the hybrid engine's stages and takes its own exact [Q, k], and the
shards' candidates (a superset of every global top-k member in that shard)
are merged by a small sort: k x n_shards entries a query cross between
devices, never the [Q, num_docs] score matrix.

The JAX engine is one program over a 1-D mesh (``shard_map`` and an
``all_gather``); here it is one process over a list of devices, one shard of
docs per entry.  A device may repeat: ``["cuda:0"] * 4`` is four shards on
one card, ``["cpu"] * 8`` the CPU stand-in for the JAX tests' 8-device mesh.

- **Doc ranges** follow the JAX rule: ``per = ceil(N / S)`` padded to whole
  65536-doc tiles from 2**19 docs, else to 128 (``hybrid_engine.padded_width``);
  shard s holds docs [s * shard_docs, (s + 1) * shard_docs), the last one
  everything past its start.
- **Heavy rows** are picked once on the *global* list lengths, within a
  *per-shard* budget of bf16 rows [T_heavy, shard_docs], and every shard
  holds the same terms in the same rows (an engine built on a shard's own
  lists would rank by its own lengths: the same answers, other rows).  So
  a batch's heavy pair table is built once; the tail chunk table is per
  shard, whose posting offsets differ.
- **Each shard is a ``HybridSearchEngine``** built from that shard's
  postings (each list's order kept) with the global heavy terms: its dense
  build, stages and exact top-k run under its own device.  Shards are built
  one at a time, and each frees its heavy postings after its dense build.
- **The merge** runs on ``devices[0]``: the shards' [Q, k_local] candidates
  (global ids, shard-major) are concatenated there, the counterpart of the
  ``all_gather`` (on one card a ``torch.cat`` with no copy between
  devices), and a stable descending sort takes the first k: score
  descending, then doc ascending, the order ``jax.lax.top_k`` gives on the
  shard-major rows.  One packed host copy a batch.

Integer (quantized) indexes only, as the JAX engine's ``exact_topk_integer``
needs.  Not ported: the opt-in ``tail_partitioned`` layout and the opt-in
``use_pallas`` tail (the port's tail is always ``scatter_scores``' chunk
entry, which computes the same sums as JAX's XLA, tiled and Pallas tails).
"""

from __future__ import annotations

import time
from collections import deque
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.device import device_scope, resolve_device
from ..index.inverted import InvertedIndexData
from ..ops import gather_rows
from .hybrid_engine import (
    HybridSearchEngine,
    padded_width,
    pick_heavy_terms,
    put_int32,
    split_terms,
    topk_to_host,
)

Device = Union[str, torch.device]


def _shard_postings(offsets, lengths, doc_ids, impacts, lo: int, hi: Optional[int]):
    """The postings with ``lo <= doc < hi`` (``hi`` None: no upper end), in
    term order with each list's order kept: (offsets, local doc ids,
    impacts)."""
    sel = doc_ids >= lo
    if hi is not None:
        sel &= doc_ids < hi
    counts = np.zeros(len(lengths), dtype=np.int64)
    nonempty = lengths > 0
    if nonempty.any():
        # segment sums over the non-empty lists, which tile the postings
        counts[nonempty] = np.add.reduceat(sel, offsets[:-1][nonempty], dtype=np.int64)
    sub_offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
    np.cumsum(counts, out=sub_offsets[1:])
    local = doc_ids[sel]
    local -= np.uint32(lo)
    return sub_offsets, local, impacts[sel]


class ShardedSearchEngine:
    """Doc-sharded batched exact scoring, one shard per entry of ``devices``."""

    def __init__(
        self,
        index: InvertedIndexData,
        devices: Optional[Sequence[Device]] = None,
        config: SearchConfig = SearchConfig(),
        heavy_min: int = 1024,
        dense_budget_bytes: int = 4 << 30,
        use_kernels: Optional[bool] = None,
    ):
        """``devices``: one shard of docs per entry (repeats allowed); None
        is one shard on each visible CUDA device, and raises without one.
        ``use_kernels`` is resolved on each shard's device, as the hybrid
        engine resolves it."""
        if config.approx_top_k:
            raise ValueError("approximate top-k is not ported; the port's top-k is exact")
        if devices is None:
            resolve_device(None)
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("devices must name at least one device")
        self.n_shards = len(self.devices)
        self.config = config
        self.vocab: Dict[str, int] = index.term_to_id
        self.num_docs = max(int(index.num_docs), 1)
        if self.num_docs >= 2**31:
            raise ValueError("doc ids must fit int32")
        impacts = np.asarray(index.impacts)
        if impacts.dtype.kind not in "iu":
            raise ValueError(
                f"ShardedSearchEngine takes integer (quantized) impacts only, got {impacts.dtype}"
            )
        impacts = impacts.astype(np.uint8, copy=False)

        self.shard_docs = padded_width(-(-self.num_docs // self.n_shards))
        self.doc_lo = np.arange(self.n_shards, dtype=np.int64) * self.shard_docs
        offsets = np.asarray(index.offsets, dtype=np.int64)
        lengths = np.diff(offsets)
        heavy_tids = pick_heavy_terms(lengths, heavy_min, dense_budget_bytes, self.shard_docs)
        self.heavy_row_arr = np.full(len(lengths), -1, dtype=np.int32)
        self.heavy_row_arr[heavy_tids] = np.arange(len(heavy_tids), dtype=np.int32)
        self.t_heavy = len(heavy_tids)

        doc_ids = np.asarray(index.doc_ids, dtype=np.uint32)
        self.split_seconds = 0.0
        self.shards: List[HybridSearchEngine] = []
        t_build = time.perf_counter()
        for s, dev in enumerate(self.devices):
            t0 = time.perf_counter()
            lo = int(self.doc_lo[s])
            hi = None if s == self.n_shards - 1 else lo + self.shard_docs
            sub_offsets, sub_docs, sub_vals = _shard_postings(offsets, lengths, doc_ids, impacts, lo, hi)
            self.split_seconds += time.perf_counter() - t0
            shard = SimpleNamespace(term_to_id=self.vocab, offsets=sub_offsets, doc_ids=sub_docs,
                                    impacts=sub_vals, num_docs=self.shard_docs)
            self.shards.append(HybridSearchEngine(shard, config, device=dev, use_kernels=use_kernels,
                                                  heavy_terms=heavy_tids))
            del shard, sub_offsets, sub_docs, sub_vals
        self.build_seconds = time.perf_counter() - t_build
        self.use_kernels = self.shards[0].use_kernels
        self._released = False

    def release(self) -> None:
        """Free every shard's device buffers; new score calls raise."""
        self._released = True
        for shard in self.shards:
            shard.release()

    def score_batch_async(
        self,
        query_term_sets: Sequence[Set[str]],
        top_k: Optional[int] = None,
    ):
        """Launch every shard's stages and top-k and the merge; returns a
        zero-arg finalizer (the hybrid engine's pipelined pattern).  Each
        shard's top-k reads a flag back per search pass, so the shards'
        launches follow each other on the host."""
        if self._released:
            raise RuntimeError("engine released")
        if top_k is None:
            top_k = self.config.top_k
        nq = len(query_term_sets)
        if nq == 0:
            return lambda: []
        k_local = min(top_k, self.shard_docs)
        k_final = min(top_k, self.num_docs, self.n_shards * k_local)
        heavy_q, heavy_rows, t_q, t_tid = split_terms(self.vocab, self.heavy_row_arr, query_term_sets)
        if not len(heavy_q) and not len(t_q):
            return lambda: [[] for _ in range(nq)]
        # the heavy rows are global: one pair table for every shard
        table = gather_rows.group_pairs(heavy_q, heavy_rows, nq) if len(heavy_q) else None

        dev0 = self.devices[0]
        heavy_on: Dict[torch.device, torch.Tensor] = {}
        vals_all, ids_all = [], []
        for shard, lo in zip(self.shards, self.doc_lo.tolist()):
            dev = shard.device
            heavy = None
            if table is not None:
                if dev not in heavy_on:
                    heavy_on[dev] = put_int32(table, dev)
                heavy = heavy_on[dev]
            tail = shard.tail_input(t_q, t_tid)
            if heavy is None and tail is None:  # no candidates in this shard
                vals_all.append(torch.zeros(nq, k_local, dtype=torch.float32, device=dev0))
                ids_all.append(torch.zeros(nq, k_local, dtype=torch.int32, device=dev0))
                continue
            with device_scope(dev):
                vals, idx = shard.topk_from_stages(heavy, tail, nq, k_local)
                gidx = torch.where(vals > 0, idx + lo, 0).to(torch.int32)
            vals_all.append(vals.to(dev0))
            ids_all.append(gidx.to(dev0))

        with device_scope(dev0):
            # shard-major [nq, S * k_local]: a stable sort keeps the doc order of ties
            vals, order = torch.sort(torch.cat(vals_all, dim=1), dim=1, descending=True, stable=True)
            ids = torch.gather(torch.cat(ids_all, dim=1), 1, order[:, :k_final])
            return topk_to_host(vals[:, :k_final], ids, dev0)

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
