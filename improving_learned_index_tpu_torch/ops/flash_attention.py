"""Flash attention with segment ids, causal or not, forward and backward.

Counterpart of the JAX library's Pallas TPU kernel that the JAX package
calls (``jax.experimental.pallas.ops.tpu.flash_attention.flash_attention``:
the forward ``pallas_call`` and, behind its ``custom_vjp``, the dk/dv and dq
kernels).  It computes softmax(sm_scale * q k^T + mask) v over q
[B, H, S, D] and k, v [B, Hkv, S, D]; query head h reads kv head
h // (H // Hkv), the same math as the JAX callers' ``jnp.repeat`` of the kv
heads.  A key is allowed where ``seg_q[b, i] == seg_kv[b, j]`` (when segment
ids are given) and, with ``causal``, where ``j <= i``.  A forbidden logit
gets the library's finite ``DEFAULT_MASK_VALUE`` (-0.7 x fp32 max) added, so
padding rows (segment 0) attend the padding keys and never give NaN.

Numerics, the library's with its default-precision (bf16) dots: q, k, v
rounded to bf16; fp32 logits, scale and mask; an fp32 softmax; p rounded to
bf16 for ``p @ v`` with fp32 accumulation; the output in q's dtype.  The
forward keeps the log-sum-exp per row (the library keeps l and m); the
backward recomputes p = exp(logit - lse), takes di = rowsum(o * do) in fp32
(as the library does outside its kernels), ds = p (dp - di) sm_scale, and
rounds p and ds to bf16 for dv = p^T do, dk = ds^T q and dq = ds k.

``flash_attention`` dispatches on the tensors' device: on the CPU its
forward and backward run the plain PyTorch versions ``flash_attention_plain``
and ``flash_attention_plain_bwd`` (the twin); on CUDA they launch the
hand-written kernels of ``csrc/flash_attention.cu`` (``ili_flash_fwd``, then
``ili_flash_bwd_dkv`` and ``ili_flash_bwd_dq``) or raise.  There is no
fallback from one to the other; ``use_kernel=False`` runs the twin on any
device.  The kernels take S a multiple of 128 and D in {64, 128}.

Layouts: q, k, v are read through their strides (head dim contiguous), so
the callers pass ``[B, S, H, D]`` projections as ``[B, H, S, D]`` views; the
kernel's output is a ``[B, H, S, D]`` view of ``[B, S, H, D]`` memory.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._kernels import CudaKernel

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
KERNEL = CudaKernel(
    "flash_attention",
    {
        "ili_flash_fwd": [_PTR] * 7 + [_STRIDES] + [_INT] * 5 + [ctypes.c_float] + [_INT] * 3 + [_PTR],
        "ili_flash_bwd_dq": [_PTR] * 9 + [_STRIDES] + [_INT] * 5 + [ctypes.c_float] + [_INT] * 2 + [_PTR],
        "ili_flash_bwd_dkv": [_PTR] * 10 + [_STRIDES] + [_INT] * 5 + [ctypes.c_float] + [_INT] * 2 + [_PTR],
    },
)
KERNEL_DIMS = (64, 128)
BLOCK = 128


def _check(q, k, v, seg_q, seg_kv):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"q, k, v must be [B, H, S, D], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[2:] != (s, d) or h % k.shape[1]:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q {tuple(q.shape)} (kv heads must divide q heads)")
    if (seg_q is None) != (seg_kv is None):
        raise ValueError("give both segment ids or neither")
    if seg_q is not None and (seg_q.shape != (b, s) or seg_kv.shape != (b, s)):
        raise ValueError(f"segment ids must be [B, S] = {(b, s)}")
    for name, t in (("k", k), ("v", v), ("seg_q", seg_q), ("seg_kv", seg_kv)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")


def _logits(q, k, seg_q, seg_kv, causal: bool, sm_scale: float):
    """fp32 [B, H, S, S] logits of bf16-rounded q, k (kv heads repeated),
    scaled, with the mask value added where a key is forbidden."""
    rep = q.shape[1] // k.shape[1]
    kf = k.to(torch.bfloat16).float().repeat_interleave(rep, dim=1)
    s = torch.matmul(q.to(torch.bfloat16).float(), kf.transpose(-1, -2)) * sm_scale
    allowed = None
    if seg_q is not None:
        allowed = (seg_q[:, :, None] == seg_kv[:, None, :])[:, None]
    if causal:
        n = q.shape[2]
        tril = torch.ones(n, n, dtype=torch.bool, device=q.device).tril()[None, None]
        allowed = tril if allowed is None else allowed & tril
    if allowed is not None:
        s = s + torch.where(allowed, 0.0, DEFAULT_MASK_VALUE)
    return s


def flash_attention_plain(q, k, v, seg_q=None, seg_kv=None, causal: bool = False, sm_scale: float = 1.0):
    """The twin: (o in q's dtype, lse fp32 [B, H, S])."""
    _check(q, k, v, seg_q, seg_kv)
    s = _logits(q, k, seg_q, seg_kv, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    rep = q.shape[1] // k.shape[1]
    vf = v.to(torch.bfloat16).float().repeat_interleave(rep, dim=1)
    o = torch.matmul(p.to(torch.bfloat16).float(), vf) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_plain_bwd(q, k, v, seg_q, seg_kv, o, lse, do, causal: bool = False, sm_scale: float = 1.0):
    """The twin's backward: (dq, dk, dv) in q's, k's and v's dtypes."""
    b, h, s_len, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    s = _logits(q, k, seg_q, seg_kv, causal, sm_scale)
    p = torch.exp(s - lse[..., None])
    dof = do.to(torch.bfloat16).float()
    di = (o.float() * do.float()).sum(dim=-1, keepdim=True)
    vf = v.to(torch.bfloat16).float().repeat_interleave(rep, dim=1)
    kf = k.to(torch.bfloat16).float().repeat_interleave(rep, dim=1)
    qf = q.to(torch.bfloat16).float()
    dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = ((dp - di) * p * sm_scale).to(torch.bfloat16).float()
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dq = torch.matmul(ds, kf)
    # kv heads shared by `rep` query heads sum their gradients
    dk = dk.view(b, hkv, rep, s_len, d).sum(dim=2)
    dv = dv.view(b, hkv, rep, s_len, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _aligned(t):
    """bf16, head dim contiguous, every (batch, head, row) stride a multiple of
    8 elements and the base 16-byte aligned, as the kernels read rows in
    16-byte vectors; otherwise a contiguous copy."""
    t = t.to(torch.bfloat16)
    if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _shape(q, k):
    b, h, s, d = q.shape
    if s % BLOCK or d not in KERNEL_DIMS:
        raise ValueError(f"flash_attention kernel takes S a multiple of {BLOCK} and D in {KERNEL_DIMS}, "
                         f"got S={s}, D={d}")
    return b, h, k.shape[1], s, d


def _segs(seg_q, seg_kv, q):
    if seg_q is None:
        dummy = torch.zeros(1, dtype=torch.int32, device=q.device)
        return dummy, dummy, 0
    return seg_q.to(torch.int32).contiguous(), seg_kv.to(torch.int32).contiguous(), 1


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def _launch_fwd(q, k, v, seg_q, seg_kv, causal: bool, sm_scale: float):
    b, h, hkv, s, d = _shape(q, k)
    out_dtype = q.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or fp32, got {q.dtype}")
    qb, kb, vb = _aligned(q), _aligned(k), _aligned(v)
    sq, skv, has_seg = _segs(seg_q, seg_kv, q)
    o = torch.empty(b, s, h, d, dtype=out_dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    KERNEL.call(
        "ili_flash_fwd", qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), sq.data_ptr(), skv.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _strides(qb, kb, vb, o), b, h, hkv, s, d, float(sm_scale),
        int(bool(causal)), has_seg, int(out_dtype == torch.float32),
        torch.cuda.current_stream(q.device).cuda_stream, device=q.device,
    )
    return o, lse


def _launch_bwd(q, k, v, seg_q, seg_kv, o, lse, do, causal: bool, sm_scale: float):
    b, h, hkv, s, d = _shape(q, k)
    qb, kb, vb, dob = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    sq, skv, has_seg = _segs(seg_q, seg_kv, q)
    di = (o.float() * do.float()).sum(dim=-1).contiguous()
    lse = lse.contiguous()
    dq = torch.empty(b, h, s, d, dtype=torch.float32, device=q.device)
    dk = torch.empty(b, hkv, s, d, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    strides = _strides(qb, kb, vb, dob)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    common = (b, h, hkv, s, d, float(sm_scale), int(bool(causal)), has_seg, stream)
    ptrs = (qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), sq.data_ptr(), skv.data_ptr(), dob.data_ptr(),
            lse.data_ptr(), di.data_ptr())
    KERNEL.call("ili_flash_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), strides, *common, device=q.device)
    KERNEL.call("ili_flash_bwd_dq", *ptrs, dq.data_ptr(), strides, *common, device=q.device)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _route(q, use_kernel: bool) -> bool:
    if not use_kernel or q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no flash_attention kernel for device {q.device}")
    return True


def flash_attention_forward(q, k, v, seg_q=None, seg_kv=None, causal: bool = False, sm_scale: float = 1.0,
                            use_kernel: bool = True):
    """(o, lse) without autograd: the kernel on CUDA, the twin on the CPU."""
    _check(q, k, v, seg_q, seg_kv)
    if _route(q, use_kernel):
        return _launch_fwd(q, k, v, seg_q, seg_kv, causal, sm_scale)
    return flash_attention_plain(q, k, v, seg_q, seg_kv, causal, sm_scale)


def flash_attention_backward(q, k, v, seg_q, seg_kv, o, lse, do, causal: bool = False, sm_scale: float = 1.0,
                             use_kernel: bool = True):
    """(dq, dk, dv): the two backward kernels on CUDA, the twin on the CPU."""
    if _route(q, use_kernel):
        return _launch_bwd(q, k, v, seg_q, seg_kv, o, lse, do, causal, sm_scale)
    return flash_attention_plain_bwd(q, k, v, seg_q, seg_kv, o, lse, do, causal, sm_scale)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal, sm_scale, use_kernel):
        o, lse = flash_attention_forward(q, k, v, seg_q, seg_kv, causal, sm_scale, use_kernel)
        ctx.save_for_backward(q, k, v, seg_q, seg_kv, o, lse)
        ctx.causal, ctx.sm_scale, ctx.use_kernel = causal, sm_scale, use_kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg_q, seg_kv, o, lse = ctx.saved_tensors
        with torch.profiler.record_function("flash_attention.backward"):
            dq, dk, dv = flash_attention_backward(q, k, v, seg_q, seg_kv, o, lse, do, ctx.causal,
                                                  ctx.sm_scale, ctx.use_kernel)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, seg_q: Optional[torch.Tensor] = None, seg_kv: Optional[torch.Tensor] = None,
                    causal: bool = False, sm_scale: float = 1.0, use_kernel: bool = True):
    """Differentiable flash attention: q [B, H, S, D], k and v [B, Hkv, S, D]
    (Hkv divides H), optional int segment ids [B, S] for queries and keys.
    Returns [B, H, S, D] in q's dtype.  The library's signature takes
    ``segment_ids=SegmentIds(q=..., kv=...)``; here they are two tensors."""
    return _FlashAttention.apply(q, k, v, seg_q, seg_kv, causal, sm_scale, use_kernel)
