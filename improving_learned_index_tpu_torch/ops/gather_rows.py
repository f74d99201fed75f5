"""Hit-row gather-accumulate: the hybrid engine's heavy-term stage, reading
only the dense rows a query batch touches.

Counterpart of ``improving_learned_index_tpu/ops/gather_rows.py``.  Output
row q is the fp32 sum of the dense rows ``dense[ids[slot]]`` over q's
(query, slot) incidence pairs; duplicate pairs express repeated terms
(reference semantics: summing whole posting lists,
src/deep_impact/inverted_index/inverted_index.py:55-62).

``accumulate_rows`` dispatches on the tensors' device: on the CPU it runs
the plain PyTorch version, on CUDA it launches the hand-written kernel
``csrc/gather_rows.cu`` or raises.  There is no fallback from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from ._kernels import CudaKernel

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
KERNEL = CudaKernel("gather_rows", {"ili_gather_rows_bf16": _ARGS, "ili_gather_rows_f32": _ARGS})
_FN = {torch.bfloat16: "ili_gather_rows_bf16", torch.float32: "ili_gather_rows_f32"}
_THREADS = 256
_MAX_STRIPS = 65535  # gridDim.y


def _check(dense, ids, pairs, counts, nq):
    if dense.dim() != 2 or dense.dtype not in _FN:
        raise ValueError(f"dense must be [t_heavy, n_pad] bf16 or fp32, got {tuple(dense.shape)} {dense.dtype}")
    if ids.dim() != 1 or pairs.dim() != 2 or pairs.shape[1] != 2 or counts.shape != (2,):
        raise ValueError("ids [H], pairs [P, 2] and counts [2] expected")
    for name, t in (("ids", ids), ("pairs", pairs), ("counts", counts)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.device != dense.device:
            raise ValueError(f"{name} on {t.device}, dense on {dense.device}")
    if nq < 0:
        raise ValueError("nq must be >= 0")


def accumulate_rows_plain(dense, ids, pairs, counts, nq: int) -> torch.Tensor:
    """Plain PyTorch version: the one-hot incidence product in fp32.

    ``w[q, slot]`` counts q's live pairs on ``slot``; the product with the
    hit rows, upcast to fp32, is exact for integer cells while sums stay
    below 2^24.  On the card the product must run in full fp32, so TF32 is
    switched off for matmuls here (it is off by default in PyTorch).
    """
    _check(dense, ids, pairs, counts, nq)
    dev = dense.device
    live = torch.arange(pairs.shape[0], device=dev) < counts[1]
    w = torch.zeros(nq, ids.shape[0], dtype=torch.float32, device=dev)
    # dead pairs (past counts[1]) add weight 0 at a valid cell: no host sync
    w.index_put_(
        (torch.where(live, pairs[:, 0], 0).long(), torch.where(live, pairs[:, 1], 0).long()),
        live.float(),
        accumulate=True,
    )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return w @ dense.index_select(0, ids.long()).float()


def pair_tables(ids, pairs, counts, nq: int):
    """(rows, qptr) for the kernel: each live pair's dense row, grouped by
    query, and each query's range in it.  Computed on the device with no
    host sync: dead pairs sort past every query."""
    dev = pairs.device
    live = torch.arange(pairs.shape[0], device=dev) < counts[1]
    key = torch.where(live, pairs[:, 0], nq)
    key, order = torch.sort(key, stable=True)
    rows = ids[torch.where(live, pairs[:, 1], 0)[order].long()]
    qptr = torch.searchsorted(
        key, torch.arange(nq + 1, device=dev, dtype=torch.int32), out_int32=True
    )
    return rows.contiguous(), qptr


def accumulate_rows(dense, ids, pairs, counts, nq: int) -> torch.Tensor:
    """Return [nq, n_pad] fp32 where row q = sum of dense rows whose
    (q, slot) incidence appears in ``pairs``.

    ``dense``: [t_heavy, n_pad] bf16 or fp32.  ``ids``: [H] int32 dense-row
    ids (entries past counts[0] ignored); ``pairs``: [P, 2] int32 (query
    row, ids slot) incidences in any order (entries past counts[1]
    ignored); ``counts``: [2] int32 (hit rows, pairs), on the same device.
    """
    if dense.device.type == "cpu":
        return accumulate_rows_plain(dense, ids, pairs, counts, nq)
    if dense.device.type != "cuda":
        raise ValueError(f"no gather_rows kernel for device {dense.device}")
    _check(dense, ids, pairs, counts, nq)
    t_heavy, n_pad = dense.shape
    vec = 16 // dense.element_size()
    if not dense.is_contiguous() or n_pad % vec or dense.data_ptr() % 16:
        raise ValueError(f"dense must be contiguous, 16-byte aligned, n_pad % {vec} == 0")
    strips = -(-n_pad // (_THREADS * vec))
    if strips > _MAX_STRIPS:
        raise ValueError(f"n_pad {n_pad} exceeds the kernel's {_MAX_STRIPS} strips")
    out = torch.empty(nq, n_pad, dtype=torch.float32, device=dense.device)
    if nq == 0:
        return out
    rows, qptr = pair_tables(ids, pairs, counts, nq)
    KERNEL.call(
        _FN[dense.dtype],
        dense.data_ptr(), rows.data_ptr(), qptr.data_ptr(), out.data_ptr(),
        nq, t_heavy, n_pad, torch.cuda.current_stream(dense.device).cuda_stream,
    )
    return out
