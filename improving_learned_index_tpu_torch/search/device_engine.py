"""On-device batched query scoring: the flat [Q, num_docs] scatter engine.

Counterpart of ``improving_learned_index_tpu/search/device_engine.py``, the
replacement for the reference's per-query Python postings loop
(src/deep_impact/inverted_index/inverted_index.py:55-62):

1. postings (doc_ids, impacts) live on the card as flat int32/float32
   arrays;
2. a query batch ships only a *chunk table*: (start, length, row) triples
   addressing fixed-size postings windows;
3. the windows are gathered, masked and scatter-added into a dense
   [Q, num_docs] accumulator, and the top-k of each row is taken.

The gather and scatter are XLA in the JAX package, not Pallas.  Here they
go through ``ops.scatter_scores.apply_tail_chunks``, which reads the chunk
table and the posting arrays in place: on CUDA tensors the hand-written
kernel, on the CPU (and on the card inside ``ops.plain_versions()``, for
cross-checks only) its plain version, which materializes the flat updates.
The table goes in slices of at most ``_MAX_UPDATES`` window positions, which
bounds the flat arrays the plain route materializes.

The top-k equals ``jax.lax.top_k``'s: values descending, the lower doc id
first among ties.  Integer impacts (quantized indexes) give integer sums,
and ``ops.exact_topk.exact_topk_integer`` selects exactly that order; float
impacts (``from_term_impacts``) take a stable descending sort.  Float sums
through atomics depend on the order of the adds in the last ulp; integer
sums are exact in any order.  Approximate top-k is not ported: asking for it
raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.device import resolve_device
from ..index.inverted import InvertedIndexData
from ..ops import scatter_scores
from ..ops.exact_topk import exact_topk_integer
from .hybrid_engine import expand_tail_chunks

DEFAULT_CHUNK = 2048
_MAX_UPDATES = 1 << 26  # window positions (chunk-table slots) applied at a time


def _pick_chunk(offsets: np.ndarray) -> int:
    """Chunk size ~ p95 posting-list length, pow2-rounded into [256, 8192]:
    short lists (in-memory eval corpora) waste far less gather bandwidth
    than a fixed 2048 window, long lists still stream in few chunks."""
    lengths = np.diff(offsets)
    lengths = lengths[lengths > 0]
    if len(lengths) == 0:
        return 256
    p95 = float(np.percentile(lengths, 95))
    c = 256
    while c < p95 and c < 8192:
        c *= 2
    return c


def _bucket(n: int, base: int = 16) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def csr_from_term_impacts(per_doc_impacts):
    """Build CSR arrays (vocab, offsets, doc_ids, impacts, num_docs) from an
    iterable of per-doc [(term, float score), ...] lists, keeping score > 0 —
    the reference SparseSearch in-memory index semantics
    (nano_beir_evaluator.py:78-101)."""
    vocab: dict = {}
    term_ids, docs, vals = [], [], []
    n_docs = 0
    for doc_id, impacts in enumerate(per_doc_impacts):
        n_docs += 1
        for term, score in impacts:
            if score <= 0:
                continue
            tid = vocab.setdefault(term, len(vocab))
            term_ids.append(tid)
            docs.append(doc_id)
            vals.append(score)
    tid_arr = np.asarray(term_ids, dtype=np.int64)
    order = np.argsort(tid_arr, kind="stable")
    counts = (
        np.bincount(tid_arr, minlength=len(vocab))
        if len(tid_arr)
        else np.zeros(len(vocab), np.int64)
    )
    offsets = np.zeros(len(vocab) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    doc_arr = (
        np.asarray(docs, dtype=np.int64)[order] if len(order) else np.empty(0, np.int64)
    )
    val_arr = (
        np.asarray(vals, dtype=np.float32)[order]
        if len(order)
        else np.empty(0, np.float32)
    )
    return vocab, offsets, doc_arr, val_arr, n_docs


class DeviceSearchEngine:
    """Batched impact scoring with postings resident in device memory."""

    def __init__(
        self,
        index: Optional[InvertedIndexData] = None,
        config: SearchConfig = SearchConfig(),
        *,
        vocab: Optional[dict] = None,
        offsets: Optional[np.ndarray] = None,
        doc_ids: Optional[np.ndarray] = None,
        impacts: Optional[np.ndarray] = None,
        num_docs: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if config.approx_top_k:
            raise ValueError("approximate top-k is not ported; the port's top-k is exact")
        self.config = config
        self.device = resolve_device(device)
        if index is not None:
            vocab = index.term_to_id
            offsets = index.offsets
            doc_ids = index.doc_ids
            impacts = index.impacts
            num_docs = index.num_docs
        self.vocab = vocab
        self.offsets = np.asarray(offsets, dtype=np.int64)  # host [V+1]
        self.chunk = _pick_chunk(self.offsets)
        self.num_docs = max(int(num_docs), 1)
        if self.num_docs >= 2**31:
            raise ValueError("doc ids must fit int32")
        impacts = np.asarray(impacts)
        # integer impacts: integer sums, selected exactly without a sort
        self.integer_scores = impacts.dtype.kind in "iub" or bool(
            np.array_equal(impacts, np.round(impacts))
        )
        has = len(doc_ids) > 0
        docs = np.asarray(doc_ids).astype(np.int32) if has else np.zeros(1, np.int32)
        vals = impacts.astype(np.float32) if has else np.zeros(1, np.float32)
        self.doc_ids = torch.from_numpy(np.ascontiguousarray(docs)).to(self.device)
        self.impacts = torch.from_numpy(np.ascontiguousarray(vals)).to(self.device)

    @classmethod
    def from_term_impacts(
        cls,
        per_doc_impacts,  # iterable of [(term, float score), ...] per doc
        config: SearchConfig = SearchConfig(),
        device: Optional[Union[str, torch.device]] = None,
    ) -> "DeviceSearchEngine":
        """Build an in-memory float-impact engine straight from encoder
        output — the reference SparseSearch in-memory index semantics
        (nano_beir_evaluator.py:78-101: keep score > 0, no quantization)."""
        vocab, offsets, doc_ids, impacts, n_docs = csr_from_term_impacts(per_doc_impacts)
        return cls(
            config=config, vocab=vocab, offsets=offsets, doc_ids=doc_ids,
            impacts=impacts, num_docs=n_docs, device=device,
        )

    def _chunk_table(
        self, query_term_sets: Sequence[Set[str]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(starts, lengths, rows) int32: each query term's posting range cut
        into ``self.chunk`` windows, in query, term and window order."""
        rows, starts, ends = [], [], []
        get = self.vocab.get
        for row, terms in enumerate(query_term_sets):
            for term in terms:
                tid = get(term)
                if tid is not None:
                    rows.append(row)
                    starts.append(self.offsets[tid])
                    ends.append(self.offsets[tid + 1])
        s, e = np.asarray(starts, np.int64), np.asarray(ends, np.int64)
        return expand_tail_chunks(s, e, np.asarray(rows, np.int64), self.chunk)

    def score_batch(
        self,
        query_term_sets: Sequence[Set[str]],
        top_k: Optional[int] = None,
    ) -> List[List[Tuple[int, float]]]:
        """Top-k (doc_id, score) per query; scores sum the impacts
        (reference SparseSearch semantics, nano_beir_evaluator.py:103-137)."""
        if top_k is None:
            top_k = self.config.top_k
        nq = len(query_term_sets)
        if nq == 0:
            return []
        k = min(top_k, self.num_docs)
        starts, lengths, rows = self._chunk_table(query_term_sets)
        if len(starts) == 0:
            return [[] for _ in range(nq)]
        dev = self.device
        scores = torch.zeros(nq, self.num_docs, dtype=torch.float32, device=dev)
        per = max(1, _MAX_UPDATES // self.chunk)
        for c0 in range(0, len(starts), per):
            table = (torch.from_numpy(a[c0 : c0 + per]).to(dev) for a in (starts, lengths, rows))
            scatter_scores.apply_tail_chunks(scores, self.doc_ids, self.impacts, *table, self.chunk)
        if self.integer_scores:
            vals, idx = exact_topk_integer(scores, k)
        else:
            vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
            vals, idx = vals[:, :k], idx[:, :k]
        del scores
        top_scores, top_docs = vals.cpu().numpy(), idx.cpu().numpy()
        n_pos = (top_scores > 0).sum(axis=1)  # scores descend: a prefix
        return [
            list(zip(top_docs[i, : n_pos[i]].tolist(), top_scores[i, : n_pos[i]].tolist()))
            for i in range(nq)
        ]
