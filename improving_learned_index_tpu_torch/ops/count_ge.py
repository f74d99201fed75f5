"""Multi-threshold count: ``counts[q, a] = |{scores[q, :] >= t[q, a]}|``.

Counterpart of ``improving_learned_index_tpu/ops/count_ge.py``: the count
that each pass of the n-ary threshold search in ``ops.exact_topk`` makes
(``_ARITY - 1`` = 7 thresholds a row, ~4 passes a batch).  The plain
version counts one threshold per pass over the row; the kernel counts all of
them in one read of the row.

``count_ge`` launches the hand-written kernel ``csrc/count_ge.cu`` where
``_kernels.launches`` says so (CUDA tensors) and runs the plain PyTorch
version otherwise; there is no fallback from one to the other.
The TPU kernel's ``N % 16384`` gate does not carry over: the kernel takes
any N, and any row stride, so a sliced view of a wider score matrix is
counted in place (never copied).
"""

from __future__ import annotations

import ctypes

import torch

from ._kernels import CudaKernel, launches, stream

KERNEL = CudaKernel(
    "count_ge",
    {"ili_count_ge": [ctypes.c_void_p] * 3
     + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]},
)
MAX_THRESHOLDS = 128  # as the JAX kernel (one lane tile)
_MAX_ROWS = 65535  # gridDim.y


def _check(scores, thresholds):
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be [Q, N] fp32, got {tuple(scores.shape)} {scores.dtype}")
    if thresholds.dim() != 2 or thresholds.dtype != torch.float32:
        raise ValueError("thresholds must be [Q, T] fp32")
    if thresholds.shape[0] != scores.shape[0]:
        raise ValueError(f"{thresholds.shape[0]} threshold rows for {scores.shape[0]} score rows")
    if not 1 <= thresholds.shape[1] <= MAX_THRESHOLDS:
        raise ValueError(f"1 to {MAX_THRESHOLDS} thresholds a row, got {thresholds.shape[1]}")
    if thresholds.device != scores.device:
        raise ValueError(f"thresholds on {thresholds.device}, scores on {scores.device}")


def count_ge_plain(scores: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one compare-and-sum pass over the row per
    threshold, so at most one bool [Q, N] temporary is alive (a broadcast
    [Q, N, T] compare is 4 GB at [64, 8.85M] and T = 7)."""
    _check(scores, thresholds)
    return torch.stack(
        [(scores >= thresholds[:, a : a + 1]).sum(dim=1) for a in range(thresholds.shape[1])],
        dim=1,
    ).to(torch.int32)


def count_ge(scores: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Return [Q, T] int32 counts of ``scores >= threshold``, per row.

    ``scores``: [Q, N] fp32, any N, rows at any stride (columns unit
    stride).  ``thresholds``: [Q, T] fp32 with 1 <= T <= 128.
    """
    if not launches(scores):
        return count_ge_plain(scores, thresholds)
    _check(scores, thresholds)
    q, n = scores.shape
    if n > 1 and scores.stride(1) != 1:
        raise ValueError("scores columns must be contiguous (unit stride)")
    if q > _MAX_ROWS:
        raise ValueError(f"{q} rows exceed the kernel's {_MAX_ROWS}")
    t = thresholds.contiguous()
    out = torch.zeros(q, t.shape[1], dtype=torch.int32, device=scores.device)
    if q == 0 or n == 0:
        return out
    KERNEL.call(
        "ili_count_ge",
        scores.data_ptr(), t.data_ptr(), out.data_ptr(), q, n, scores.stride(0), t.shape[1],
        stream(scores), device=scores.device,
    )
    return out
