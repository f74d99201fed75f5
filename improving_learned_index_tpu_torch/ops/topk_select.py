"""Device-resident exact selection for ``ops.exact_topk``: each row's k-th
score from one value histogram, and the per-256-doc block counts.

No counterpart in the JAX package, whose top-k finds the k-th score by an
n-ary search (a host read of its convergence flag each pass) and leaves the
block counts to XLA.  Scores are sums of 8-bit impacts, so small
non-negative integers in fp32: where the caller bounds them below ``BINS``,
a histogram of the values gives each row's k-th score ``s_k`` (the largest
s with |{score >= s}| >= k, or 1 where a row has fewer than k positives) on
the card, with no host read.

- ``value_histogram(scores)``: ([Q, BINS] int32 counts of each value >= 1,
  [Q, ceil(N / 256)] int32 largest value of each 256-doc block);
- ``kth_scores(hist, k)``: [Q, 1] fp32 ``s_k``;
- ``block_counts(scores, s_k, block_max=None)``: two [Q, ceil(N / 256)]
  int32 tables, the docs > s_k and == s_k of each 256-doc block; given the
  block maxima, the kernel reads only the blocks that reach ``s_k``.

Each launches the hand-written kernels ``csrc/topk_select.cu`` where
``_kernels.launches`` says so (CUDA tensors) and runs its plain PyTorch
version otherwise, never a fallback from one to the other.  Like
``count_ge``, the kernels take any N and any row stride (a sliced view of a
wider matrix is read in place).  Scores must lie in [0, BINS): the caller's bound.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._kernels import CudaKernel, launches, stream

BINS = 8192  # csrc/topk_select.cu's kBins: holds 32 terms of 8-bit impacts
BLOCK = 256  # docs a selection block (ops.exact_topk's rank-j gather)
_MAX_ROWS = 65535  # gridDim.y of the block counts

_P = ctypes.c_void_p
KERNEL = CudaKernel(
    "topk_select",
    {
        "ili_topk_histogram": [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P],
        "ili_topk_kth": [_P, _P, ctypes.c_int, ctypes.c_int, _P],
        "ili_topk_block_counts": [_P, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, _P, _P, _P, _P, _P],
    },
)


def _check_scores(scores: torch.Tensor) -> None:
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be [Q, N] fp32, got {tuple(scores.shape)} {scores.dtype}")


def _check_launch(scores: torch.Tensor) -> None:
    """The kernels' limits on the scores they read."""
    _check_scores(scores)
    if scores.shape[1] > 1 and scores.stride(1) != 1:
        raise ValueError("scores columns must be contiguous (unit stride)")
    if scores.shape[0] > _MAX_ROWS:
        raise ValueError(f"{scores.shape[0]} rows exceed the kernel's {_MAX_ROWS}")


def _n_blocks(n: int) -> int:
    return -(-n // BLOCK)


def value_histogram_plain(scores: torch.Tensor):
    """Plain PyTorch version of ``value_histogram``."""
    _check_scores(scores)
    q, n = scores.shape
    bins = scores.clamp(max=BINS - 1).to(torch.int64)
    rows = torch.arange(q, device=scores.device)[:, None] * BINS
    hist = torch.bincount((bins + rows).view(-1), minlength=q * BINS).view(q, BINS).to(torch.int32)
    hist[:, 0] = 0  # zero is never selected
    blocks = F.pad(bins, (0, _n_blocks(n) * BLOCK - n)).view(q, -1, BLOCK)
    return hist, blocks.amax(dim=2).to(torch.int32)


def value_histogram(scores: torch.Tensor):
    """Return ([Q, BINS] int32 counts of each integer value >= 1 of each row,
    [Q, ceil(N / 256)] int32 largest value of each 256-doc block).

    ``scores``: [Q, N] fp32, integer-valued, in [0, BINS); any N, rows at
    any stride (columns unit stride).
    """
    if not launches(scores):
        return value_histogram_plain(scores)
    _check_launch(scores)
    q, n = scores.shape
    hist = torch.zeros(q, BINS, dtype=torch.int32, device=scores.device)
    block_max = torch.empty(q, _n_blocks(n), dtype=torch.int32, device=scores.device)
    if q and n:
        KERNEL.call("ili_topk_histogram", scores.data_ptr(), q, n, scores.stride(0), hist.data_ptr(),
                    block_max.data_ptr(), stream(scores), device=scores.device)
    return hist, block_max


def kth_scores_plain(hist: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of ``kth_scores``."""
    at_least = hist.flip(1).cumsum(dim=1).flip(1)  # [Q, BINS]: |{v >= s}|
    return (at_least[:, 1:] >= k).sum(dim=1, keepdim=True).clamp_min(1).to(torch.float32)


def kth_scores(hist: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's k-th score, [Q, 1] fp32: the largest s >= 1 with
    |{v >= s}| >= k in its histogram ([Q, BINS] int32), 1 where none."""
    if hist.dim() != 2 or hist.shape[1] != BINS or hist.dtype != torch.int32:
        raise ValueError(f"hist must be [Q, {BINS}] int32, got {tuple(hist.shape)} {hist.dtype}")
    if not launches(hist):
        return kth_scores_plain(hist, k)
    q = hist.shape[0]
    hist = hist.contiguous()
    s_k = torch.empty(q, 1, dtype=torch.float32, device=hist.device)
    if q:
        KERNEL.call("ili_topk_kth", hist.data_ptr(), s_k.data_ptr(), q, int(k), stream(hist),
                    device=hist.device)
    return s_k


def block_counts_plain(scores: torch.Tensor, s_k: torch.Tensor, block_max=None):
    """Plain PyTorch version of ``block_counts`` (reads every block): two
    compare-and-sum passes, one bool [Q, N] temporary at a time."""
    _check_scores(scores)
    q, n = scores.shape
    blocks = F.pad(scores, (0, _n_blocks(n) * BLOCK - n)).view(q, -1, BLOCK)
    s3 = s_k[:, :, None]
    return (blocks > s3).sum(dim=2, dtype=torch.int32), (blocks == s3).sum(dim=2, dtype=torch.int32)


def block_counts(scores: torch.Tensor, s_k: torch.Tensor, block_max=None):
    """Return ([Q, nb] int32 docs > s_k, [Q, nb] int32 docs == s_k) of each
    256-doc block, nb = ceil(N / 256); the ragged last block counts its
    docs only.

    ``scores`` as ``value_histogram``'s (any fp32 values here); ``s_k``:
    [Q, 1] fp32; ``block_max``: ``value_histogram``'s block maxima, or None.
    """
    if s_k.shape != (scores.shape[0], 1) or s_k.dtype != torch.float32:
        raise ValueError(f"s_k must be [Q, 1] fp32, got {tuple(s_k.shape)} {s_k.dtype}")
    if not launches(scores):
        return block_counts_plain(scores, s_k, block_max)
    _check_launch(scores)
    q, n = scores.shape
    nb = _n_blocks(n)
    if block_max is not None and (block_max.shape != (q, nb) or not block_max.is_contiguous()):
        raise ValueError(f"block_max must be a contiguous [{q}, {nb}], got {tuple(block_max.shape)}")
    s_k = s_k.contiguous()
    gt = torch.empty(q, nb, dtype=torch.int32, device=scores.device)
    eq = torch.empty(q, nb, dtype=torch.int32, device=scores.device)
    if q and n:
        KERNEL.call("ili_topk_block_counts", scores.data_ptr(), q, n, scores.stride(0),
                    s_k.data_ptr(), None if block_max is None else block_max.data_ptr(),
                    gt.data_ptr(), eq.data_ptr(), stream(scores), device=scores.device)
    return gt, eq
