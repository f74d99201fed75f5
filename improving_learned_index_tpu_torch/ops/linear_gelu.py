"""The encoder FFN's first product with its bias and GELU in one kernel:
``gelu(bf16(bf16(x @ weight.T) + bf16(bias)))``, the exact (erf) GELU.

No counterpart in the JAX package's kernels: XLA runs the product and fuses
the bias add and the GELU after it there.  ``linear_gelu`` rounds where the
JAX package rounds, as ``encoder_epilogue.bias_gelu`` does after a
bias-free product: the product in bf16, then the bias add once more, then
the GELU in fp32 rounded to bf16.

``linear_gelu(x, weight, bias)`` launches the hand-written kernel of
``csrc/linear_gelu.cu`` where ``_kernels.launches`` says so (CUDA tensors),
and otherwise (the CPU, or the card inside ``_kernels.plain_versions()``)
runs its plain PyTorch version ``linear_gelu_plain`` (differentiable),
never a fallback.  The kernel takes x [T, K] bf16, weight [N, K] bf16
(``nn.Linear``'s layout, K-major as ``F.linear`` takes it) and bias [N]
fp32, contiguous and 16-byte aligned, K % 64 == 0 and N % 8 == 0
(``takes``), and no autograd.  ``KERNEL.calls`` counts launches by C
function.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._kernels import CudaKernel, launches, stream
from .encoder_epilogue import bias_gelu_plain

K_STEP = 64  # the kernel's k-tile depth

_P = ctypes.c_void_p
KERNEL = CudaKernel(
    "linear_gelu",
    {"ili_linear_gelu": [_P] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P]},
)


def takes(in_features: int, out_features: int) -> bool:
    """True where the kernel takes a product of these widths."""
    return in_features > 0 and in_features % K_STEP == 0 and out_features > 0 and out_features % 8 == 0


def linear_gelu_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``linear_gelu``: the bias-free product, then
    ``encoder_epilogue``'s bias and GELU."""
    return bias_gelu_plain(F.linear(x, weight), bias)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got {t.dtype} {list(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def linear_gelu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``gelu(F.linear(x, weight) + bias.to(x.dtype))`` (erf) for [..., K]
    inputs ``x``, an [N, K] ``weight`` and an [N] ``bias``: [..., N]."""
    if not launches(x):
        return linear_gelu_plain(x, weight, bias)
    ts = (x, weight, bias)
    if any(t.device != x.device for t in ts):
        raise ValueError(f"operands on {sorted({str(t.device) for t in ts})}, not one device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise ValueError("the linear_gelu kernel has no backward: call it without grad")
    n, k = weight.shape
    if not takes(k, n):
        raise ValueError(f"weight [{n}, {k}]: the kernel takes K % {K_STEP} == 0 and N % 8 == 0")
    _check("x", x, torch.bfloat16, (*x.shape[:-1], k))
    _check("weight", weight, torch.bfloat16, (n, k))
    _check("bias", bias, torch.float32, (n,))
    rows = x.numel() // k
    out = torch.empty(*x.shape[:-1], n, dtype=torch.bfloat16, device=x.device)
    if rows:
        KERNEL.call("ili_linear_gelu", x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), rows, n, k,
                    stream(x), device=x.device)
    return out
