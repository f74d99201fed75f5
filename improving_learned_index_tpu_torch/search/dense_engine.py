"""Dense scoring for in-memory evaluation corpora.

Counterpart of ``improving_learned_index_tpu/search/dense_engine.py``.  The
reference scores NanoBEIR queries with a Python dict-accumulation loop
(src/deep_impact/evaluation/nano_beir_evaluator.py:112-133).  When the
corpus is small enough, the term-impact matrix M [V, D] is materialized
once on the card and a query batch is scored as

    scores[B, D] = onehot_queries[B, V] @ M[V, D]

The JAX package computes that product in XLA at ``Precision.HIGHEST`` with
an fp32 result.  In torch a bf16 @ bf16 product returns bf16 and rounds sums
above 256, so the port takes ``ops.gather_rows.accumulate_grouped`` instead:
the fp32 sum of the bf16 (or fp32) rows each query hits, reading only those
rows, with the pairs grouped on the host (``group_pairs``) and staged in one
upload (on the card the hand-written ``gather_rows`` kernel; on the CPU, and
with ``use_kernels=False``, its plain version: the one-hot product in fp32,
TF32 off).  Integer impacts (<= 255, exact in bf16) give sums equal to the
host engine's bit for bit; float impacts keep fp32 rows, summed in another
order than the JAX product (the last ulp may differ).

The top-k stays on the host (``host_topk``), as in the JAX package, with
boundary ties in doc-id order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.config import SearchConfig
from ..core.device import resolve_device, resolve_use_kernels
from ..index.inverted import InvertedIndexData
from ..ops import gather_rows


def _bucket(n: int, base: int = 64) -> int:
    b = base
    while b < n:
        b *= 2
    return b


def host_topk(scores: np.ndarray, k: int):
    """Rows of (doc, score) pairs, score desc then doc asc, zeros dropped.

    Boundary ties at the k-th score are taken in doc-id order, as every
    other engine takes them (the JAX package's version picks them by
    ``argpartition``, in no promised order)."""
    out = []
    k = min(k, scores.shape[1])
    for row in scores:
        idx = np.flatnonzero(row > 0)
        vals = row[idx]
        if k < len(idx):
            keep = vals >= np.partition(vals, len(vals) - k)[len(vals) - k]
            idx, vals = idx[keep], vals[keep]
        order = np.lexsort((idx, -vals))[:k]
        out.append(list(zip(idx[order].tolist(), vals[order].tolist())))
    return out


class DenseSearchEngine:
    """Batched scoring as the fp32 sum of the impact-matrix rows each query
    hits."""

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
        use_kernels: Optional[bool] = None,
    ):
        self.config = config
        self.device = dev = resolve_device(device)
        self.use_kernels = resolve_use_kernels(dev, use_kernels)
        self._accumulate_grouped = (
            gather_rows.accumulate_grouped if self.use_kernels
            else gather_rows.accumulate_grouped_plain
        )
        if index is not None:
            vocab = index.term_to_id
            offsets = index.offsets
            doc_ids = index.doc_ids
            impacts = index.impacts
            num_docs = index.num_docs
        self.vocab = vocab
        self.num_docs = max(int(num_docs), 1)
        v = len(vocab)
        d_pad = max(_bucket(self.num_docs, base=128), 128)
        offsets = np.asarray(offsets, dtype=np.int64)
        impacts = np.asarray(impacts, dtype=np.float32)
        # int impacts (quantized indexes) are exact in bf16 (values <= 255);
        # float impacts keep fp32 to match the host engine.
        is_int = np.allclose(impacts, np.round(impacts)) and (impacts.max(initial=0.0) <= 256)
        dtype = torch.bfloat16 if is_int else torch.float32
        term_of = np.repeat(np.arange(v), np.diff(offsets))
        cell = term_of * d_pad + np.asarray(doc_ids, dtype=np.int64)
        # a repeated (term, doc) keeps its last impact, as numpy's assignment
        last = len(cell) - 1 - np.unique(cell[::-1], return_index=True)[1]
        # [V+1, D]: one extra all-zero row, as the JAX matrix
        self.impact_matrix = torch.zeros((v + 1) * d_pad, dtype=dtype, device=dev)
        self.impact_matrix[torch.from_numpy(cell[last]).to(dev)] = (
            torch.from_numpy(impacts[last]).to(dev).to(dtype)
        )
        self.impact_matrix = self.impact_matrix.view(v + 1, d_pad)

    @classmethod
    def fits(cls, num_terms: int, num_docs: int, budget_bytes: int = 1 << 30) -> bool:
        # conservative fp32 sizing (float-impact matrices stay fp32)
        return (num_terms + 1) * max(_bucket(num_docs, 128), 128) * 4 <= budget_bytes

    @classmethod
    def from_term_impacts(
        cls,
        per_doc_impacts,
        config: SearchConfig = SearchConfig(),
        device: Optional[Union[str, torch.device]] = None,
        use_kernels: Optional[bool] = None,
    ):
        from .device_engine import csr_from_term_impacts

        vocab, offsets, doc_ids, impacts, n_docs = csr_from_term_impacts(per_doc_impacts)
        return cls(
            config=config, vocab=vocab, offsets=offsets, doc_ids=doc_ids, impacts=impacts,
            num_docs=n_docs, device=device, use_kernels=use_kernels,
        )

    def score_batch(
        self, query_term_sets: Sequence[Set[str]], top_k: Optional[int] = None
    ) -> List[List[Tuple[int, float]]]:
        if top_k is None:
            top_k = self.config.top_k
        nq = len(query_term_sets)
        if nq == 0:
            return []
        k = min(top_k, self.num_docs)
        get = self.vocab.get
        pairs = sorted({
            (q, tid) for q, terms in enumerate(query_term_sets)
            for tid in (get(t) for t in terms) if tid is not None
        })
        if not pairs:
            return [[] for _ in range(nq)]
        q_of, tids = np.asarray(pairs, dtype=np.int64).T
        table = torch.from_numpy(gather_rows.group_pairs(q_of, tids, nq)).to(self.device)
        scores = self._accumulate_grouped(self.impact_matrix, table, nq)
        return host_topk(scores[:, : self.num_docs].cpu().numpy(), k)
