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
hand-written kernels of ``csrc/flash_attention.cu`` (``ili_flash_fwd``; the
backward ``ili_flash_bwd_prep``, di = rowsum(o * do) and the fp32 dq
accumulator zeroed, then ``ili_flash_bwd``, dk and dv written once and dq
added in fp32 by atomic adds) or raise.  There is no fallback from one to
the other; ``use_kernel=False`` runs the twin on any device.  The kernels
take S a multiple of 128 and D in {64, 128}.

The kernels compute only the tiles that may hold an allowed (query, key)
pair: ``tile_pairs`` is their rule in plain PyTorch, and
``computed_tile_pairs`` reads the kernels' own count of the tiles they
computed, so the card tests and ``chip_smoke.py`` hold the two to each
other.

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
        "ili_flash_fwd": [_PTR] * 7 + [_STRIDES] + [_INT] * 5 + [ctypes.c_float] + [_INT] * 4 + [_PTR] * 2,
        "ili_flash_bwd_prep": [_PTR] * 4 + [_STRIDES] + [_INT] * 6 + [_PTR],
        "ili_flash_bwd": [_PTR] * 11 + [_STRIDES] + [_INT] * 5 + [ctypes.c_float] + [_INT] * 4 + [_PTR] * 2,
    },
)
KERNEL_DIMS = (64, 128)
BLOCK = 128
# The tile rule's grain: 64 query rows (a consumer warpgroup's rows) by a
# 128-key tile; each 64-row tile's ids are summarised as a mask of the ids
# modulo 64, and only the first SUMMARISED tiles of 64 rows are.
TILE_Q, TILE_K, SUMMARISED = 64, 128, 256


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


def _skip(seg_q, seg_kv) -> int:
    """1 where dropping tiles with no allowed pair is exact: no segment ids,
    or one tensor for both sides, so every row's own key is allowed.  Two
    tensors (which may differ) make the kernels compute every tile."""
    if seg_q is None or seg_q is seg_kv:
        return 1
    same = (seg_q.data_ptr(), seg_q.dtype, seg_q.shape, seg_q.stride()) == \
        (seg_kv.data_ptr(), seg_kv.dtype, seg_kv.shape, seg_kv.stride())
    return int(same)


def _tile_ids(seg, s: int):
    """Per 64-row tile of each row: which ids occur, modulo 64 ([B, S/64, 64]
    bool, the kernels' 64-bit mask), the least and the largest id."""
    t = seg.reshape(seg.shape[0], s // TILE_Q, TILE_Q).long()
    present = torch.zeros(*t.shape[:2], 64, dtype=torch.bool, device=seg.device)
    present.scatter_(2, t % 64, True)
    return present, t.amin(-1), t.amax(-1)


def tile_pairs(seg_q, seg_kv, causal: bool, s: int, batch: int = 1):
    """The kernels' tile rule over pairs of a 64-row query tile and a 128-key
    tile, as bool [B, S/64, S/128] tensors ``(may, full)``.

    ``may``: the pair may hold an allowed (query, key) pair and is computed;
    the kernels drop every other pair, which holds none.  Per 64-key half:
    causal, the half does not start past the query tile's last row; and the
    two tiles' id masks meet (or a tile lies past the first ``SUMMARISED``).
    ``full``: every pair of the two tiles is allowed (below the diagonal, one
    id on both sides), so the per-element mask is skipped.  Without segment
    ids (``seg_q`` None) every id is 0 and ``batch`` gives B."""
    if s % BLOCK:
        raise ValueError(f"S must be a multiple of {BLOCK}, got {s}")
    if seg_q is None:
        seg_q = seg_kv = torch.zeros(batch, s, dtype=torch.int32)
    pq, loq, hiq = _tile_ids(seg_q, s)
    pk, lok, hik = _tile_ids(seg_kv, s)
    n = s // TILE_Q
    qa = torch.arange(n, device=pq.device)[:, None]
    ka = torch.arange(n, device=pq.device)[None, :]
    meet = torch.matmul(pq.float(), pk.float().transpose(1, 2)) > 0
    may = meet | (qa >= SUMMARISED) | (ka >= SUMMARISED)
    uniform = (loq == hiq)[:, :, None] & (lok == hik)[:, None, :] & (loq[:, :, None] == lok[:, None, :])
    full = uniform & (qa < SUMMARISED) & (ka < SUMMARISED)
    if causal:
        may = may & (ka <= qa)
        full = full & (ka < qa)
    halves = (pq.shape[0], n, s // TILE_K, TILE_K // TILE_Q)
    return may.view(halves).any(-1), full.view(halves).all(-1)


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(*(st for t in ts for st in t.stride()[:3]))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(q, k, v, seg_q, seg_kv, causal: bool, sm_scale: float, tiles=None):
    b, h, hkv, s, d = _shape(q, k)
    out_dtype = q.dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"q must be bf16 or fp32, got {q.dtype}")
    qb, kb, vb = _aligned(q), _aligned(k), _aligned(v)
    skip = _skip(seg_q, seg_kv)
    sq, skv, has_seg = _segs(seg_q, seg_kv, q)
    o = torch.empty(b, s, h, d, dtype=out_dtype, device=q.device).permute(0, 2, 1, 3)
    lse = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    KERNEL.call(
        "ili_flash_fwd", qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), sq.data_ptr(), skv.data_ptr(),
        o.data_ptr(), lse.data_ptr(), _strides(qb, kb, vb, o), b, h, hkv, s, d, float(sm_scale),
        int(bool(causal)), has_seg, skip, int(out_dtype == torch.float32), _ptr(tiles),
        torch.cuda.current_stream(q.device).cuda_stream, device=q.device,
    )
    return o, lse


def _launch_bwd(q, k, v, seg_q, seg_kv, o, lse, do, causal: bool, sm_scale: float, tiles=None):
    b, h, hkv, s, d = _shape(q, k)
    if o.dtype not in (torch.bfloat16, torch.float32) or do.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"o and do must be bf16 or fp32, got {o.dtype}, {do.dtype}")
    o, do = (t if t.stride(3) == 1 else t.contiguous() for t in (o, do))
    qb, kb, vb, dob = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    skip = _skip(seg_q, seg_kv)
    sq, skv, has_seg = _segs(seg_q, seg_kv, q)
    lse = lse.contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    di = torch.empty(b, h, s, dtype=torch.float32, device=q.device)
    dq = torch.empty(b, h, s, d, dtype=torch.float32, device=q.device)
    KERNEL.call("ili_flash_bwd_prep", o.data_ptr(), do.data_ptr(), di.data_ptr(), dq.data_ptr(), _strides(o, do),
                b, h, s, d, int(o.dtype == torch.float32), int(do.dtype == torch.float32), stream,
                device=q.device)
    kv_dtype = torch.float32 if k.dtype == torch.float32 else torch.bfloat16
    dk = torch.empty(b, hkv, s, d, dtype=kv_dtype, device=q.device)
    dv = torch.empty_like(dk)
    KERNEL.call("ili_flash_bwd", qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), sq.data_ptr(), skv.data_ptr(),
                dob.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                _strides(qb, kb, vb, dob), b, h, hkv, s, d, float(sm_scale), int(bool(causal)), has_seg, skip,
                int(kv_dtype == torch.float32), _ptr(tiles), stream, device=q.device)
    # dq is summed in fp32 across key tiles and converted once; dk and dv
    # come out in k's dtype (bf16 for any other)
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
    """(dq, dk, dv): the backward kernels on CUDA, the twin on the CPU."""
    if _route(q, use_kernel):
        return _launch_bwd(q, k, v, seg_q, seg_kv, o, lse, do, causal, sm_scale)
    return flash_attention_plain_bwd(q, k, v, seg_q, seg_kv, o, lse, do, causal, sm_scale)


def computed_tile_pairs(q, k, v, seg_q=None, seg_kv=None, causal: bool = False, sm_scale: float = 1.0):
    """(forward, backward): the (64-row query, 128-key) tile pairs that one
    launch of the forward kernel and one of the backward kernel computed at
    these inputs, over every query head and batch row, as the kernels count
    them on the card.  Where tiles are dropped, ``tile_pairs``' rule gives
    H times the sum of its ``may``; otherwise every tile is computed."""
    _check(q, k, v, seg_q, seg_kv)
    if not _route(q, True):
        raise ValueError(f"the kernels count tiles on a CUDA tensor, got {q.device}")
    counts = torch.zeros(2, dtype=torch.int64, device=q.device)
    o, lse = _launch_fwd(q, k, v, seg_q, seg_kv, causal, sm_scale, tiles=counts[0:1])
    _launch_bwd(q, k, v, seg_q, seg_kv, o, lse, o, causal, sm_scale, tiles=counts[1:2])
    fwd, bwd = counts.tolist()
    return fwd, bwd


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
