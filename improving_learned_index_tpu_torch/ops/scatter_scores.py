"""Tail scatter: apply sparse (query, doc, impact) updates to a dense score
matrix.

Counterpart of ``improving_learned_index_tpu/ops/scatter_scores.py``
(reference semantics: the per-posting ``scores[doc] += impact`` loop in
src/deep_impact/inverted_index/inverted_index.py:55-62).

``apply_tail_updates`` dispatches on the tensors' device: on the CPU it runs
the plain PyTorch version, on CUDA it launches the hand-written kernel
``csrc/scatter_scores.cu`` or raises.  There is no fallback from one to the
other.

Unlike the JAX function, which returns a new array, both versions update
``scores`` in place and return it: at corpus scale the score matrix is
[64, 8.85M] fp32 (2.3 GB), and a copy per batch would double its traffic.
"""

from __future__ import annotations

import ctypes

import torch

from ._kernels import CudaKernel

KERNEL = CudaKernel(
    "scatter_scores",
    {"ili_scatter_scores": [ctypes.c_void_p] * 4
     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]},
)


def _check(scores, d, v, r):
    if scores.dim() != 2 or scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous [nq, n_pad] fp32 tensor")
    if not (d.shape == v.shape == r.shape) or d.dim() != 1:
        raise ValueError("d, v and r must be flat arrays of one length")
    if d.dtype != torch.int32 or r.dtype != torch.int32 or v.dtype != torch.float32:
        raise ValueError("d and r must be int32 and v fp32")
    for name, t in (("d", d), ("v", v), ("r", r)):
        if t.device != scores.device:
            raise ValueError(f"{name} on {t.device}, scores on {scores.device}")


def apply_tail_updates_plain(scores, d, v, r) -> torch.Tensor:
    """Plain PyTorch version: accumulate ``index_put_`` in place.  Padding
    (v == 0) is redirected to cell [0, 0], where it adds an exact zero, so
    no host sync is needed to drop it."""
    _check(scores, d, v, r)
    pad = v == 0
    idx = (torch.where(pad, 0, r).long(), torch.where(pad, 0, d).long())
    return scores.index_put_(idx, v, accumulate=True)


def apply_tail_updates(scores, d, v, r) -> torch.Tensor:
    """``scores[r[i], d[i]] += v[i]`` for every i, exactly, in place.

    ``scores``: [nq, n_pad] fp32; ``d``/``r`` int32 and ``v`` fp32 flat
    update arrays of any length.  Updates with v == 0 are padding and
    ignored.  Impacts are integers (quantized lattice), so fp32 sums are
    exact in any order below 2^24.
    """
    if scores.device.type == "cpu":
        return apply_tail_updates_plain(scores, d, v, r)
    if scores.device.type != "cuda":
        raise ValueError(f"no scatter_scores kernel for device {scores.device}")
    _check(scores, d, v, r)
    for name, t in (("d", d), ("v", v), ("r", r)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d.numel() == 0:
        return scores
    nq, n_pad = scores.shape
    KERNEL.call(
        "ili_scatter_scores",
        scores.data_ptr(), d.data_ptr(), v.data_ptr(), r.data_ptr(),
        d.numel(), nq, n_pad, torch.cuda.current_stream(scores.device).cuda_stream,
    )
    return scores
