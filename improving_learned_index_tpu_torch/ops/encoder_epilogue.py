"""The encoder layer's elementwise passes between its matrix products:
bias adds, residual adds, LayerNorms and the GELU (``models/encoder.py``).

No counterpart in the JAX package's kernels: XLA fuses these passes there.
Each entry rounds where the JAX package rounds (the flax ``Dense`` rounds
its product to the compute dtype, then its bias add once more):

- ``bias_add(q, k, v, q_bias, k_bias, v_bias)``: ``y + b.to(y.dtype)`` for
  the three [T, N] products q, k and v, each bias [N] fp32;
- ``bias_gelu(h, bias)``: ``gelu(h + b.to(h.dtype))``, the exact (erf) GELU;
- ``bias_residual_layernorm(h, bias, x, weight, norm_bias, eps)``:
  ``layer_norm((x + (h + b.to(h.dtype))).float()).to(h.dtype)``, the
  LayerNorm in fp32 with fp32 ``weight`` and ``norm_bias``.

Each launches the hand-written kernels of ``csrc/encoder_epilogue.cu``
where ``_kernels.launches`` says so (CUDA tensors), and otherwise (the CPU,
or the card inside ``_kernels.plain_versions()``) runs its plain PyTorch
version (the ``*_plain`` twin, differentiable), never a fallback.  The kernels
take bf16 products of width N % 8 == 0 (``bias_residual_layernorm`` N <=
``MAX_NORM_WIDTH``), contiguous, 16-byte aligned, and no autograd: they
raise where an input requires grad.  ``bias_add`` on the card adds in
place and returns its inputs; ``bias_add_plain`` is the twin of one of
its three adds.  ``KERNEL.calls`` counts launches by C function.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from ._kernels import CudaKernel, launches, stream

MAX_NORM_WIDTH = 1024  # four bf16 x 8 vectors a lane of the row's warp
_MAX_VECS = 2**31  # the kernels index 16-byte vectors with 32 bits

_P = ctypes.c_void_p
KERNEL = CudaKernel(
    "encoder_epilogue",
    {
        "ili_bias_add": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, _P],
        "ili_bias_gelu": [_P] * 3 + [ctypes.c_longlong, ctypes.c_int, _P],
        "ili_bias_residual_layernorm": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _P],
    },
)


def takes(hidden: int, intermediate: int) -> bool:
    """True where the kernels take a layer of these widths."""
    return hidden % 8 == 0 and intermediate % 8 == 0 and 0 < hidden <= MAX_NORM_WIDTH and intermediate > 0


def bias_add_plain(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of one of ``bias_add``'s adds (a new tensor)."""
    return y + bias.to(y.dtype)


def bias_gelu_plain(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``bias_gelu``."""
    return F.gelu(h + bias.to(h.dtype), approximate="none")


def bias_residual_layernorm_plain(h, bias, x, weight, norm_bias, eps: float) -> torch.Tensor:
    """Plain PyTorch version of ``bias_residual_layernorm``."""
    dt = h.dtype
    return F.layer_norm((x + (h + bias.to(dt))).float(), (h.shape[-1],), weight, norm_bias, eps).to(dt)


def _check_launch(*ts: torch.Tensor) -> None:
    """The kernels' operands: on one device, none needing grad."""
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"operands on {sorted({str(t.device) for t in ts})}, not one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("the encoder_epilogue kernels have no backward: call them without grad")


def _check_rows(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name} must be bf16, got {t.dtype}")
    if t.shape[-1] != n or n % 8:
        raise ValueError(f"{name} width {t.shape[-1]} must be {n}, a multiple of 8")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if t.numel() // 8 >= _MAX_VECS:
        raise ValueError(f"{name} has {t.numel()} elements, past the kernels' 32-bit vector index")


def _check_vector(name: str, t: torch.Tensor, n: int) -> None:
    if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous 16-byte aligned [{n}] fp32, got {tuple(t.shape)} {t.dtype}")


def bias_add(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_bias: torch.Tensor, k_bias: torch.Tensor,
             v_bias: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``y + b.to(y.dtype)`` for the [..., N] products q, k and v, of one
    shape, and their [N] biases.  On the card in place, in one launch."""
    ys, biases = (q, k, v), (q_bias, k_bias, v_bias)
    if not launches(q):
        return tuple(bias_add_plain(y, b) for y, b in zip(ys, biases))
    _check_launch(*ys, *biases)
    n = q.shape[-1]
    for y, b in zip(ys, biases):
        if y.shape != q.shape:
            raise ValueError(f"products of shapes {tuple(q.shape)} and {tuple(y.shape)}")
        _check_rows("product", y, n)
        _check_vector("bias", b, n)
    rows = q.numel() // n
    if rows:
        KERNEL.call("ili_bias_add", *(y.data_ptr() for y in ys), *(b.data_ptr() for b in biases), rows, n,
                    stream(q), device=q.device)
    return ys


def bias_gelu(h: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``gelu(h + bias.to(h.dtype))`` (erf) for a [..., N] product and an
    [N] bias."""
    if not launches(h):
        return bias_gelu_plain(h, bias)
    _check_launch(h, bias)
    n = h.shape[-1]
    _check_rows("h", h, n)
    _check_vector("bias", bias, n)
    out = torch.empty_like(h)
    if h.numel():
        KERNEL.call("ili_bias_gelu", h.data_ptr(), bias.data_ptr(), out.data_ptr(), h.numel() // n, n,
                    stream(h), device=h.device)
    return out


def bias_residual_layernorm(h: torch.Tensor, bias: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                            norm_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """``layer_norm((x + (h + bias.to(h.dtype))).float()).to(h.dtype)``: a
    [..., H] product ``h``, its [H] bias, the [..., H] residual ``x``, and
    the LayerNorm's [H] fp32 ``weight`` and ``norm_bias``."""
    if not launches(h):
        return bias_residual_layernorm_plain(h, bias, x, weight, norm_bias, eps)
    _check_launch(h, bias, x, weight, norm_bias)
    n = h.shape[-1]
    if x.shape != h.shape:
        raise ValueError(f"residual {tuple(x.shape)} and product {tuple(h.shape)} differ")
    if n > MAX_NORM_WIDTH:
        raise ValueError(f"width {n} past the LayerNorm kernel's {MAX_NORM_WIDTH}")
    _check_rows("h", h, n)
    _check_rows("x", x, n)
    for name, t in (("bias", bias), ("weight", weight), ("norm_bias", norm_bias)):
        _check_vector(name, t, n)
    out = torch.empty_like(h)
    if h.numel():
        KERNEL.call("ili_bias_residual_layernorm", h.data_ptr(), bias.data_ptr(), x.data_ptr(), weight.data_ptr(),
                    norm_bias.data_ptr(), out.data_ptr(), h.numel() // n, n, float(eps), stream(h),
                    device=h.device)
    return out
