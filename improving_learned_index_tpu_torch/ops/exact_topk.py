"""Exact top-k for integer-valued score rows, without a full sort.

Counterpart of ``improving_learned_index_tpu/ops/exact_topk.py``.  Impact
scores are sums of 8-bit quantized impacts, i.e. exact small integers,
which admits an exact selection in a few bandwidth passes:

1. per row, find the k-th score value ``s_k`` (the largest s with
   |{score >= s}| >= k).  Two routes, chosen by what the caller can vouch
   for:

   - **histogram** (``max_score`` given and below ``topk_select.BINS``):
     one value histogram a row and a scan of it, on the card
     (``ops.topk_select``), with no host read;
   - **n-ary search** (otherwise; the JAX package's route): ``_ARITY - 1``
     thresholds a pass, counted by ``ops.count_ge`` (on the card its
     hand-written kernel, all thresholds of a pass in one read of the row),
     until every row has converged.  The convergence test reads one bool a
     pass back to the host, each read inside the region
     ``search/topk_sync`` (``core.profiling.annotate``): a trace counts the
     host syncs by those regions;

2. the selected set is every doc with score > s_k, plus the first (k - m)
   docs with score == s_k in doc-id order (the reference heapq.nlargest also
   picks a subset of boundary ties, inverted_index.py:62).  Both collapse
   into one non-decreasing selection rank ``sel(i)``; the j-th selected doc
   is the first position where sel >= j;
3. ``sel`` is never built at full width: per-256-doc-block int32 counts
   (``topk_select.block_counts``; after the histogram it reads only the
   blocks whose maximum reaches s_k), a tiny [Q, N/256] scan, a batched
   searchsorted for each rank's owning block, and a local scan inside the
   gathered [Q, k, 256] blocks;
4. a stable descending sort of the [Q, k] candidates orders them by score,
   so boundary ties stay in doc-id order.

Both routes give the same ``s_k``, so the same answer byte for byte.  Of
the plain versions (the CPU's, and the card's inside
``_kernels.plain_versions()``),
the search's count and the block counts stay at one bool [Q, N] temporary
at a time: the plain count (``count_ge_plain``) takes one pass per
threshold, and the greater/equal block counts are two passes instead of
one packed sum.

Zero scores are never selected (s_k >= 1); rows with fewer than k positive
docs pad with (score 0, doc 0) entries, which callers filter.
"""

from __future__ import annotations

import torch

from ..core.profiling import annotate
from . import topk_select
from .count_ge import count_ge
from .topk_select import BINS, BLOCK as _BLOCK

_ARITY = 8  # thresholds per search pass + 1, as in the JAX package


def _searching(lo: torch.Tensor, hi: torch.Tensor) -> bool:
    """The search's convergence test: a host sync, one a pass and one more
    at the end."""
    with annotate("search/topk_sync"):
        return bool((lo < hi).any())


def _search(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The n-ary search for each row's s_k over [1, row_max],
    [Q, 1] fp32; if a row has < k positives, its s_k is 1."""
    q, dev = scores.shape[0], scores.device
    lo = torch.ones(q, 1, device=dev)
    hi = scores.amax(dim=1, keepdim=True).clamp_min(1.0)
    frac = torch.arange(1, _ARITY, device=dev, dtype=torch.float32) / _ARITY
    inf = torch.tensor(float("inf"), device=dev)
    while _searching(lo, hi):
        width = hi - lo + 1.0
        t = torch.minimum(lo + torch.ceil(frac[None, :] * width), hi)  # [Q, A-1]
        counts = count_ge(scores, t)
        ok = counts >= k  # monotone non-increasing along the threshold axis
        new_lo = torch.where(ok, t, lo).amax(dim=1, keepdim=True)
        new_hi = torch.minimum(torch.where(ok, inf, t).amin(dim=1, keepdim=True) - 1.0, hi)
        lo, hi = new_lo, new_hi
    return lo


def exact_topk_integer(scores: torch.Tensor, k: int, *, max_score=None):
    """Exact top-k over integer-valued non-negative fp32 scores.

    Args:
        scores: [Q, N] float32, integer-valued, >= 0.
        k: number of results per row.
        max_score: a bound the caller guarantees on every score, or None.
            Below ``topk_select.BINS`` the k-th scores come from a value
            histogram with no host read; otherwise from the n-ary search.
    Returns:
        (values [Q, min(k, N)] float32 desc-sorted with ties in doc-id
        order, indices [Q, min(k, N)] int32).  Rows with fewer than k
        positive scores pad with value 0 and index 0.
    """
    q, n = scores.shape
    k = min(k, n)
    dev = scores.device

    # -- 1. the k-th score s_k of each row, [Q, 1] -----------------------------
    if max_score is not None and max_score < BINS:
        hist, block_max = topk_select.value_histogram(scores)
        s_k = topk_select.kth_scores(hist, k)
    else:
        s_k, block_max = _search(scores, k), None

    # -- 2. block-level selection-rank table (int32) ---------------------------
    blk_hi, blk_eq = topk_select.block_counts(scores, s_k, block_max)  # [Q, nb]
    nb = blk_hi.shape[1]
    s_k3 = s_k[:, :, None]
    cum_hi = blk_hi.cumsum(dim=1, dtype=torch.int32)
    cum_eq = blk_eq.cumsum(dim=1, dtype=torch.int32)
    m = cum_hi[:, -1:]  # sure-selections per row (< k by construction)
    cap = (k - m).clamp_min(0)  # boundary-tie quota
    sel_end = cum_hi + torch.minimum(cum_eq, cap)  # sel at each block's last doc
    total = sel_end[:, -1:]  # min(k, positives at or above s_k)

    # -- 3. rank j -> owning block -> exact position ---------------------------
    targets = torch.arange(1, k + 1, device=dev, dtype=torch.int32).expand(q, k).contiguous()
    blk = torch.searchsorted(sel_end, targets).clamp_max(nb - 1)  # [Q, k]
    pre_hi = torch.gather(cum_hi - blk_hi, 1, blk)
    pre_eq = torch.gather(cum_eq - blk_eq, 1, blk)
    cols = blk[:, :, None] * _BLOCK + torch.arange(_BLOCK, device=dev)  # [Q, k, BLOCK]
    seg = torch.gather(scores, 1, cols.view(q, -1).clamp_max(n - 1)).view(q, k, _BLOCK)
    if n % _BLOCK:  # the ragged last block's columns past n score 0
        seg = torch.where(cols < n, seg, 0.0)
    local_hi = (seg > s_k3).cumsum(dim=2, dtype=torch.int32)
    local_eq = (seg == s_k3).cumsum(dim=2, dtype=torch.int32)
    sel_local = (
        pre_hi[:, :, None]
        + local_hi
        + torch.minimum(pre_eq[:, :, None] + local_eq, cap[:, :, None])
    )  # [Q, k, BLOCK]: sel at every doc of the owning block
    pos = (sel_local < targets[:, :, None]).sum(dim=2).clamp_max(_BLOCK - 1)
    idx = blk * _BLOCK + pos  # [Q, k]
    vals = torch.gather(seg, 2, pos[:, :, None]).squeeze(2)
    vals = torch.where(targets <= total, vals, 0.0)

    # -- 4. order the k candidates by score (stable: ties keep doc order) ------
    vals_sorted, order = torch.sort(vals, dim=1, descending=True, stable=True)
    idx_sorted = torch.gather(idx, 1, order)
    return vals_sorted, torch.where(vals_sorted > 0, idx_sorted, 0).to(torch.int32)
