"""Attention for short sequences (the retrieval encode path, S <= 256).

Counterpart of ``improving_learned_index_tpu/ops/short_attention.py``:
softmax(q k^T * sm_scale + mask) v with the TPU kernel's numerics -- q, k
and v rounded to bf16, fp32 logits, -1e9 added where the mask forbids, an
fp32 max-subtracted softmax, bf16 probabilities, an fp32-accumulated
``probs @ v`` returned in q's dtype.  The softmax normalizes by one
reciprocal of the row sum and a multiply (the JAX kernel divides; the two
differ by an fp32 ulp before the bf16 rounding).

Two masks: ``packed=False`` takes a key-padding mask (0 = padding key);
``packed=True`` takes sequence-packing segment ids (0 = padding, 1..n per
packed document), and a token attends only to keys of its own segment
(padding attends to padding).

``short_attention`` dispatches on the tensors' device: on the CPU it runs
the plain PyTorch version ``short_attention_plain``, on CUDA it launches the
hand-written kernel ``csrc/short_attention.cu`` or raises.  There is no
fallback from one to the other; ``use_kernel=False`` runs the plain version
on any device (the encoder's ``use_kernels=False`` route).

Its backward is the JAX ``custom_vjp``'s: whichever forward ran, it
recomputes attention through ``reference_attention`` (a copy of the JAX
``_reference_attention``) under autograd.  That recompute rounds the logits
to bf16 (a bf16 product) where the forward keeps them in fp32, so the
backward differentiates the JAX package's XLA-route math, not the forward's
(the kernel has no backward, as the TPU kernel has none).  Both routes share
this one backward, so a gradient on the CPU is the gradient the card
computes.

Layouts: the kernel reads q, k and v through their strides (TMA tensor maps
built per call: the head dim contiguous, every other stride a multiple of
16 bytes, 16-byte aligned), so the encoder passes ``[B, S, H, D]``
projections as ``[B, H, S, D]`` views without a copy; the kernel's output is
a ``[B, H, S, D]`` view of ``[B, S, H, D]`` memory, which the encoder's
output projection reads without a transpose.  The kernel's design (persistent
blocks over (batch, head) items, a TMA ring, wgmma) is described in
``csrc/short_attention.cu``.
"""

from __future__ import annotations

import ctypes

import torch

from ._kernels import CudaKernel

KERNEL = CudaKernel(
    "short_attention",
    {"ili_short_attention": [ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
     + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]},
)
KERNEL_SEQS = (128, 256)
KERNEL_DIMS = (16, 32, 64, 128)


def can_use_short_attention(seq_len: int, head_dim: int) -> bool:
    """The JAX package's gate: S <= 256, S % 128 == 0, head dim % 8 == 0."""
    return seq_len <= 256 and seq_len % 128 == 0 and head_dim % 8 == 0


def _check(q, k, v, segment_mask):
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be [B, H, S, D] of one shape, got {q.shape}, {k.shape}, {v.shape}")
    b, _, s, _ = q.shape
    if segment_mask.shape != (b, s):
        raise ValueError(f"segment_mask must be [B, S] = {(b, s)}, got {tuple(segment_mask.shape)}")
    for name, t in (("k", k), ("v", v), ("segment_mask", segment_mask)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def short_attention_plain(q, k, v, segment_mask, sm_scale: float, packed: bool = False):
    """Plain PyTorch version, the kernel's arithmetic step by step (fp32
    products of bf16-rounded operands; on the card fp32 matmuls run in full
    fp32 unless TF32 was switched on, which the port never does)."""
    _check(q, k, v, segment_mask)
    qf, kf, vf = (t.to(torch.bfloat16).float() for t in (q, k, v))
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    seg = segment_mask
    if packed:
        forbidden = seg[:, None, :, None] != seg[:, None, None, :]
    else:
        forbidden = (seg == 0)[:, None, None, :]
    logits = logits + torch.where(forbidden, -1e9, 0.0).to(torch.float32)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = (p * (1.0 / p.sum(dim=-1, keepdim=True))).to(torch.bfloat16)
    return torch.matmul(probs.float(), vf).to(q.dtype)


def reference_attention(q, k, v, segment_mask, sm_scale: float, packed: bool = False):
    """The JAX ``_reference_attention`` (the XLA route's math, which its
    ``custom_vjp`` differentiates): a bf16 q k^T rounded to bf16, then fp32
    and scaled; the -1e9 bias; an fp32 softmax rounded to bf16; a bf16
    probs @ v, returned in q's dtype."""
    bf16 = torch.bfloat16
    logits = torch.matmul(q.to(bf16), k.to(bf16).transpose(-1, -2)).float() * sm_scale
    if packed:
        forbidden = segment_mask[:, None, :, None] != segment_mask[:, None, None, :]
    else:
        forbidden = (segment_mask == 0)[:, None, None, :]
    bias = torch.where(forbidden, -1e9, 0.0).to(torch.float32)
    probs = torch.softmax(logits + bias, dim=-1).to(bf16)
    return torch.matmul(probs, v.to(bf16)).to(q.dtype)


def _launch(q, k, v, segment_mask, sm_scale: float, packed: bool):
    _check(q, k, v, segment_mask)
    b, h, s, d = q.shape
    if s not in KERNEL_SEQS or d not in KERNEL_DIMS:
        raise ValueError(
            f"short_attention kernel takes S in {KERNEL_SEQS} and D in {KERNEL_DIMS}, got S={s}, D={d}"
        )
    out_dtype = q.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or fp32, got {q.dtype}")
    # the kernel's first step, as in the TPU kernel: operands in bf16
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous, strides multiples of 8, 16-byte aligned")
    seg = segment_mask.to(torch.int32).contiguous()
    if seg.data_ptr() % 16:  # the kernel copies each row with one 16-byte-aligned bulk copy
        seg = seg.clone()
    out = torch.empty(b, s, h, d, dtype=out_dtype, device=q.device).permute(0, 2, 1, 3)
    strides = (ctypes.c_longlong * 12)(*(st for t in (q, k, v, out) for st in t.stride()[:3]))
    KERNEL.call(
        "ili_short_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(), strides,
        b, h, s, d, float(sm_scale), int(bool(packed)), int(out_dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream, device=q.device,
    )
    return out


class _ShortAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment_mask, sm_scale, packed, use_kernel):
        ctx.save_for_backward(q, k, v, segment_mask)
        ctx.sm_scale, ctx.packed = sm_scale, packed
        if not use_kernel or q.device.type == "cpu":
            return short_attention_plain(q, k, v, segment_mask, sm_scale, packed)
        if q.device.type != "cuda":
            raise ValueError(f"no short_attention kernel for device {q.device}")
        return _launch(q, k, v, segment_mask, sm_scale, packed)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, segment_mask = ctx.saved_tensors
        with torch.enable_grad(), torch.profiler.record_function("short_attention.backward"):
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = reference_attention(*leaves, segment_mask, ctx.sm_scale, ctx.packed)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None, None, None


def short_attention(q, k, v, segment_mask, sm_scale: float, packed: bool = False,
                    use_kernel: bool = True):
    """Batched attention for S <= 256.

    q, k, v: [B, H, S, D] (bf16 in the model; fp32 is rounded to bf16 as the
    TPU kernel does); segment_mask: [B, S] int.  Returns [B, H, S, D] in q's
    dtype.  On CUDA the kernel takes S in {128, 256} and D in {16, 32, 64,
    128} and raises on other shapes; ``use_kernel=False`` runs the plain
    version instead.  Either way the backward recomputes through
    ``reference_attention``.
    """
    return _ShortAttention.apply(q, k, v, segment_mask, sm_scale, packed, use_kernel)
