"""Llama-family decoder (PyTorch ``nn.Module``s) -- the doc2query expansion model.

Counterpart of ``improving_learned_index_tpu/models/llama.py``: GQA attention
with rotary embeddings (HF rotate-half layout), RMSNorm in fp32, a SiLU-gated
MLP, a static-shape KV cache (bf16 in the compute dtype, or int8 with
per-(token, head) fp32 scales folded into the logits and the probabilities,
so the cache is never dequantized as a whole), a prefill mask (causal and
padding), the cache-slot mask (a query written at ``cache_index + i`` sees
the valid slots up to its own) and an optional tied-embedding head.

Parameters keep the flax tree's names and layouts, so a JAX parameter tree
carries across leaf for leaf (``llama_flax_params_to_port``): Dense kernels
are ``[in, out]``, ``q/k/v_proj`` ``[hidden, heads, head_dim]``, ``o_proj``
``[heads, head_dim, hidden]``, the state dict keys are the tree's paths
joined by dots (``layer_0.attention.q_proj.kernel``).  Every projection casts
its input and kernel to the compute dtype (flax ``DenseGeneral(dtype=...)``),
the embedding lookup is cast after the gather, the head runs in fp32.

Precision follows the JAX module's dtype promotion: RoPE multiplies the
compute-dtype q and k by fp32 cos/sin, so q and k are fp32 from there on and
the XLA-route logits are an fp32 product (with a cache, the cache's k is
promoted to fp32 for it); the probabilities are cast to the compute dtype
before ``probs @ v``.

Attention takes the library flash kernel's route (``ops.flash_attention``,
causal, the attention mask as segment ids) when ``use_flash_attention`` is
set, no cache is given and segment ids are (the cache-less forward); the JAX
package takes it only on a TPU, the port on any device (the hand-written
kernel on the card, its plain twin on the CPU).  Every other call runs the
XLA route's math in plain torch ops.

``LlamaModel.forward(..., params=tree)`` runs on a parameter tree in place
of the module's own parameters: each sub-module's subtree is dequantized
(``models.quantization``: int8 ``{"q", "s"}`` and packed-int4 ``{"q4",
"s"}`` leaves) in the compute dtype right before that sub-module runs, so a
quantized tree never exists as a whole in full precision (the JAX sampler's
dequantize-at-each-use).  Build the module on the ``meta`` device to hold no
weights of its own.  Tensor-parallel partition specs (JAX
``llama_param_specs``) are not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..ops.flash_attention import flash_attention
from .encoder import compute_dtype
from .quantization import dequantize_params


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # KV-cache storage: "none" keeps compute-dtype caches; "int8" stores
    # per-(token, head) symmetric int8 K/V with fp32 scales, folded into the
    # attention's logits and probabilities.
    kv_quant: str = "none"
    # Cache-less attention through ops.flash_attention (causal, the attention
    # mask as segment ids): no fp32 [B, H, S, S] logits in device memory.
    use_flash_attention: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def tiny(vocab_size: int = 256) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            intermediate_size=128,
            max_position_embeddings=128,
        )

    @staticmethod
    def llama2_7b() -> "LlamaConfig":
        """meta-llama/Llama-2-7b-hf's published config."""
        return LlamaConfig()


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, L] -> cos/sin [B, L, head_dim] fp32 (HF rotate-half
    layout: frequencies repeated across the two halves)."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    freqs = positions[..., None].to(torch.float32) * inv_freq[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H, D]; cos/sin: [B, L, D].  Promotes to fp32, as the JAX
    product of a compute-dtype x with fp32 cos/sin does."""
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None, :] + rotated * sin[:, :, None, :]


def _kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, token, head) symmetric int8 of [B, L, H, D]: (int8 values,
    fp32 scales [B, L, H]), computed in fp32."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


class RMSNorm(nn.Module):
    def __init__(self, hidden: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(hidden, device=device))

    def forward(self, x):
        x32 = x.to(torch.float32)
        norm = x32 * torch.rsqrt(torch.mean(x32 ** 2, dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(x.dtype)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral`` without bias: ``kernel`` is
    ``in_shape + out_shape``; the last ``len(in_shape)`` axes of the input are
    contracted, input and kernel cast to ``dtype`` first."""

    def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...], device=None):
        super().__init__()
        self.n_in = len(in_shape)
        self.kernel = nn.Parameter(torch.empty(*in_shape, *out_shape, device=device))

    def forward(self, x, dtype: torch.dtype):
        k = self.kernel
        in_size = math.prod(k.shape[:self.n_in])
        lead = x.shape[:x.dim() - self.n_in]
        y = x.reshape(*lead, in_size).to(dtype) @ k.reshape(in_size, -1).to(dtype)
        return y.reshape(*lead, *k.shape[self.n_in:])


class Embed(nn.Module):
    def __init__(self, vocab: int, hidden: int, device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, hidden, device=device))

    def forward(self, ids):
        return self.embedding[ids]


def _cache_update(cache: torch.Tensor, new: torch.Tensor, index: int) -> torch.Tensor:
    """``lax.dynamic_update_slice_in_dim`` along axis 1, in place."""
    cache[:, index:index + new.shape[1]] = new.to(cache.dtype)
    return cache


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        hd = c.head_dim
        self.q_proj = Dense((c.hidden_size,), (c.num_heads, hd), device)
        self.k_proj = Dense((c.hidden_size,), (c.num_kv_heads, hd), device)
        self.v_proj = Dense((c.hidden_size,), (c.num_kv_heads, hd), device)
        self.o_proj = Dense((c.num_heads, hd), (c.hidden_size,), device)

    def forward(self, x, positions, attention_bias, kv_cache=None, cache_index=None, segment_ids=None,
                use_kernels: bool = True):
        c = self.config
        dt = compute_dtype(c)
        hd = c.head_dim
        q, k, v = self.q_proj(x, dt), self.k_proj(x, dt), self.v_proj(x, dt)
        cos, sin = rope_cos_sin(positions, hd, c.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        k_scale = v_scale = None
        rep = c.num_heads // c.num_kv_heads
        if kv_cache is not None and len(kv_cache) == 4:
            # int8 cache: this step's K/V quantized post-RoPE; the scales are
            # constant along head_dim, so they factor out of q k^T and into
            # the probabilities before probs @ v
            kq, ks, vq, vs = kv_cache
            nk_q, nk_s = _kv_quantize(k)
            nv_q, nv_s = _kv_quantize(v)
            kq, ks = _cache_update(kq, nk_q, cache_index), _cache_update(ks, nk_s, cache_index)
            vq, vs = _cache_update(vq, nv_q, cache_index), _cache_update(vs, nv_s, cache_index)
            new_cache = (kq, ks, vq, vs)
            k, v = kq.to(dt), vq.to(dt)
            k_scale, v_scale = ks, vs
            if rep > 1:
                k_scale = k_scale.repeat_interleave(rep, dim=2)
                v_scale = v_scale.repeat_interleave(rep, dim=2)
        elif kv_cache is not None:
            ck, cv = kv_cache
            k, v = _cache_update(ck, k, cache_index), _cache_update(cv, v, cache_index)
            new_cache = (k, v)
        else:
            new_cache = None

        if c.use_flash_attention and kv_cache is None and segment_ids is not None:
            # kv head h // rep for query head h in the kernel: no repeat
            seg = segment_ids.to(torch.int32)
            ctx = flash_attention(
                q.to(dt).permute(0, 2, 1, 3), k.to(dt).permute(0, 2, 1, 3), v.to(dt).permute(0, 2, 1, 3),
                seg, seg, causal=True, sm_scale=float(1.0 / np.sqrt(hd)), use_kernel=use_kernels,
            )
            return self.o_proj(ctx.permute(0, 2, 1, 3).to(dt), dt), new_cache

        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        work = torch.promote_types(q.dtype, k.dtype)
        logits = torch.matmul(q.to(work).permute(0, 2, 1, 3), k.to(work).permute(0, 2, 3, 1)).to(torch.float32)
        if k_scale is not None:
            logits = logits * k_scale.permute(0, 2, 1)[:, :, None, :]
        logits = logits / np.float32(np.sqrt(hd)) + attention_bias
        probs = torch.softmax(logits, dim=-1)
        if v_scale is not None:
            probs = probs * v_scale.permute(0, 2, 1)[:, :, None, :]
        probs = probs.to(dt)
        ctx = torch.matmul(probs, v.to(dt).permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        return self.o_proj(ctx, dt), new_cache


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.gate_proj = Dense((c.hidden_size,), (c.intermediate_size,), device)
        self.up_proj = Dense((c.hidden_size,), (c.intermediate_size,), device)
        self.down_proj = Dense((c.intermediate_size,), (c.hidden_size,), device)

    def forward(self, x):
        dt = compute_dtype(self.config)
        gate = self.gate_proj(x, dt)
        # jax.nn.silu: x * sigmoid(x), the sigmoid rounded to the dtype first
        return self.down_proj(gate * torch.sigmoid(gate) * self.up_proj(x, dt), dt)


class LlamaLayer(nn.Module):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.attention = LlamaAttention(c, device)
        self.mlp = LlamaMLP(c, device)
        self.input_norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)
        self.post_attn_norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)

    def forward(self, x, positions, attention_bias, kv_cache=None, cache_index=None, segment_ids=None,
                use_kernels: bool = True):
        h, new_cache = self.attention(self.input_norm(x), positions, attention_bias, kv_cache, cache_index,
                                      segment_ids, use_kernels)
        x = x + h
        x = x + self.mlp(self.post_attn_norm(x))
        return x, new_cache


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _call(module: nn.Module, subtree: Optional[Dict[str, Any]], dtype: torch.dtype, *args, **kwargs):
    """``module(*args)``, on ``subtree`` (dequantized in ``dtype`` first)
    in place of its own parameters when one is given."""
    if subtree is None:
        return module(*args, **kwargs)
    return functional_call(module, _flat(dequantize_params(subtree, dtype)), args, kwargs, strict=True)


def attention_bias(attention_mask: torch.Tensor, qlen: int, kv_caches=None, cache_index=None) -> torch.Tensor:
    """The additive fp32 mask [B, 1, L, S]: prefill, causal and the key
    padding; with caches, the valid slots up to each query's own slot."""
    if kv_caches is None:
        causal = torch.ones(qlen, qlen, dtype=torch.bool, device=attention_mask.device).tril()
        mask = causal[None, None] & attention_mask[:, None, None, :].bool()
    else:
        s_len = kv_caches[0][0].shape[1]
        slot_ids = torch.arange(s_len, device=attention_mask.device)[None, None, None, :]
        q_ids = (cache_index + torch.arange(qlen, device=attention_mask.device))[None, None, :, None]
        mask = attention_mask[:, None, None, :].bool() & (slot_ids <= q_ids)
    return torch.where(mask, 0.0, torch.finfo(torch.float32).min).to(torch.float32)


class LlamaModel(nn.Module):
    """Decoder producing fp32 logits.  Prefill: ``kv_caches=None``, the
    causal and padding mask over the prompt.  Decode: ``kv_caches`` (from
    ``make_kv_caches``, updated in place and returned), ``attention_mask``
    [B, S] over the cache's slots, ``cache_index`` the write offset."""

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        c = config
        self.config = c
        self.embed_tokens = Embed(c.vocab_size, c.hidden_size, device)
        for i in range(c.num_layers):
            self.add_module(f"layer_{i}", LlamaLayer(c, device))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)
        if not c.tie_word_embeddings:
            self.lm_head = Dense((c.hidden_size,), (c.vocab_size,), device)

    def forward(self, input_ids, attention_mask, positions=None, kv_caches=None, cache_index=None,
                params: Optional[Dict[str, Any]] = None, use_kernels: bool = True):
        c = self.config
        dt = compute_dtype(c)
        sub = (lambda name: params[name]) if params is not None else (lambda name: None)
        x = _call(self.embed_tokens, sub("embed_tokens"), dt, input_ids).to(dt)
        bsz, qlen = input_ids.shape
        if positions is None:
            positions = torch.arange(qlen, device=input_ids.device)[None].expand(bsz, qlen)
        bias = attention_bias(attention_mask, qlen, kv_caches, cache_index)
        seg_ids = attention_mask if c.use_flash_attention and kv_caches is None else None
        new_caches = []
        for i in range(c.num_layers):
            cache_i = kv_caches[i] if kv_caches is not None else None
            x, new_cache = _call(getattr(self, f"layer_{i}"), sub(f"layer_{i}"), dt, x, positions, bias,
                                 cache_i, cache_index, seg_ids, use_kernels)
            new_caches.append(new_cache)
        x = _call(self.norm, sub("norm"), dt, x)
        if c.tie_word_embeddings:
            embed = params["embed_tokens"]["embedding"] if params is not None else self.embed_tokens.embedding
            embed = dequantize_params(embed, dt) if isinstance(embed, dict) else embed
            logits = torch.matmul(x.to(torch.float32), embed.to(torch.float32).t())
        else:
            logits = _call(self.lm_head, sub("lm_head"), dt, x.to(torch.float32), torch.float32)
        return logits, (new_caches if kv_caches is not None else None)


def make_kv_caches(config: LlamaConfig, batch: int, max_len: int, dtype=None, device=None) -> list:
    """Per-layer caches: (k, v) in the compute dtype, or with ``kv_quant ==
    "int8"`` the 4-tuple (k int8, k_scale fp32, v int8, v_scale fp32)."""
    shape = (batch, max_len, config.num_kv_heads, config.head_dim)
    if config.kv_quant == "int8":
        sshape = shape[:-1]
        return [
            (torch.zeros(shape, dtype=torch.int8, device=device), torch.zeros(sshape, device=device),
             torch.zeros(shape, dtype=torch.int8, device=device), torch.zeros(sshape, device=device))
            for _ in range(config.num_layers)
        ]
    dtype = compute_dtype(config) if dtype is None else dtype
    return [
        (torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(config.num_layers)
    ]


# -- parameter trees -----------------------------------------------------------


def param_shapes(config: LlamaConfig) -> Dict[str, Any]:
    """The flax parameter tree's shapes (nested dicts of tuples)."""
    c = config
    hd = c.head_dim
    shapes: Dict[str, Any] = {"embed_tokens": {"embedding": (c.vocab_size, c.hidden_size)},
                              "norm": {"scale": (c.hidden_size,)}}
    for i in range(c.num_layers):
        shapes[f"layer_{i}"] = {
            "attention": {
                "q_proj": {"kernel": (c.hidden_size, c.num_heads, hd)},
                "k_proj": {"kernel": (c.hidden_size, c.num_kv_heads, hd)},
                "v_proj": {"kernel": (c.hidden_size, c.num_kv_heads, hd)},
                "o_proj": {"kernel": (c.num_heads, hd, c.hidden_size)},
            },
            "mlp": {
                "gate_proj": {"kernel": (c.hidden_size, c.intermediate_size)},
                "up_proj": {"kernel": (c.hidden_size, c.intermediate_size)},
                "down_proj": {"kernel": (c.intermediate_size, c.hidden_size)},
            },
            "input_norm": {"scale": (c.hidden_size,)},
            "post_attn_norm": {"scale": (c.hidden_size,)},
        }
    if not c.tie_word_embeddings:
        shapes["lm_head"] = {"kernel": (c.hidden_size, c.vocab_size)}
    return shapes


def _map_shapes(fn, tree, path=()):
    return {k: _map_shapes(fn, v, path + (k,)) if isinstance(v, dict) else fn(path + (k,), v)
            for k, v in tree.items()}


@torch.no_grad()
def init_llama_params(config: LlamaConfig, seed: int = 0, device=None,
                      dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """A random parameter tree with flax's initializer shapes and scales (not
    its numbers): embeddings and kernels truncated normal (2 sigma) with std
    1/sqrt(fan_in) (fan_in the hidden size for the embedding, the contracted
    axes for a kernel), norm scales 1.  Drawn on ``device`` from ``seed``,
    leaf by leaf, stored in ``dtype``."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)

    def draw(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape, dtype=dtype, device=device)
        fan_in = shape[1] if path[-2] == "embed_tokens" else (
            shape[0] * shape[1] if path[-2] == "o_proj" else shape[0])
        std = fan_in ** -0.5 / 0.87962566103423978
        leaf = torch.empty(shape, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(leaf, 0.0, std, -2 * std, 2 * std, generator=gen)
        return leaf.to(dtype)

    return _map_shapes(draw, param_shapes(config))


def _check_tree(params: Dict[str, Any], want: Dict[str, Any]) -> None:
    """Raise unless ``params`` holds every leaf of the shape tree ``want``
    at its shape (a quantized leaf at its full-precision shape)."""

    def shape_of(x):
        if isinstance(x, dict) and "q" in x:
            return tuple(x["q"].shape)
        if isinstance(x, dict) and "q4" in x:
            return (2 * x["q4"].shape[0], *x["q4"].shape[1:])
        return tuple(x.shape)

    def walk(w, p, path):
        for k, v in w.items():
            if k not in p:
                raise KeyError(f"parameter tree lacks {'/'.join(path + (k,))}")
            if isinstance(v, dict):
                walk(v, p[k], path + (k,))
            elif shape_of(p[k]) != v:
                raise ValueError(f"{'/'.join(path + (k,))}: shape {shape_of(p[k])}, config wants {v}")

    walk(want, params, ())


def _to_torch(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.array(x, order="C"))


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def llama_flax_params_to_port(params: Dict[str, Any], config: LlamaConfig) -> Dict[str, Any]:
    """The JAX package's Llama parameter tree (numpy leaves, as
    ``jax.device_get`` or ``core.flax_msgpack.read`` give it; quantized
    ``{"q", "s"}`` / ``{"q4", "s"}`` leaves too) as the port's tree of CPU
    tensors: the same names, layouts and dtypes (checked against
    ``config``)."""
    tree = tree_map(_to_torch, params)
    _check_tree(tree, param_shapes(config))
    return tree


def llama_port_params_to_flax(params: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse: numpy leaves (a bf16 leaf stays a CPU bf16 tensor, which
    ``core.flax_msgpack.write`` stores as flax does)."""
    def leaf(t):
        t = t.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()

    return tree_map(leaf, params)


def tree_to(params: Dict[str, Any], device=None, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Every leaf moved to ``device``; with ``dtype``, the floating kernels and
    the embedding (leaves of 2 or more axes) cast to it.  Quantized leaves
    keep their integers and fp32 scales; norm scales stay as they are."""
    def walk(x):
        if isinstance(x, dict) and set(x) in ({"q", "s"}, {"q4", "s"}):
            return {k: v.to(device) for k, v in x.items()}
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if dtype is not None and x.is_floating_point() and x.dim() >= 2:
            x = x.to(device=device, dtype=dtype)
        return x.to(device)

    return walk(params)


def load_llama_params(model: LlamaModel, params: Dict[str, Any]) -> LlamaModel:
    """Copy a full-precision tree into ``model``'s parameters."""
    model.load_state_dict(_flat(params), strict=True)
    return model


def llama_params(model: LlamaModel) -> Dict[str, Any]:
    """``model``'s parameters as a tree (the tensors themselves)."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        node = tree
        *head, last = name.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = p
    return tree


def hf_llama_to_port(state_dict: Dict[str, Any], config: LlamaConfig) -> Dict[str, Any]:
    """An HF ``LlamaForCausalLM`` state dict as the port's tree (fp32 CPU
    tensors), the layout ``hf_llama_to_flax`` gives."""

    def get(name):
        t = state_dict[name]
        t = t.detach().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
        return t.to(torch.float32)

    H, heads, kv_heads, hd = config.hidden_size, config.num_heads, config.num_kv_heads, config.head_dim
    params: Dict[str, Any] = {
        "embed_tokens": {"embedding": get("model.embed_tokens.weight").contiguous()},
        "norm": {"scale": get("model.norm.weight").contiguous()},
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": get("lm_head.weight").t().contiguous()}
    for i in range(config.num_layers):
        p = f"model.layers.{i}"
        params[f"layer_{i}"] = {
            "input_norm": {"scale": get(f"{p}.input_layernorm.weight").contiguous()},
            "post_attn_norm": {"scale": get(f"{p}.post_attention_layernorm.weight").contiguous()},
            "attention": {
                "q_proj": {"kernel": get(f"{p}.self_attn.q_proj.weight").t().reshape(H, heads, hd).contiguous()},
                "k_proj": {"kernel": get(f"{p}.self_attn.k_proj.weight").t().reshape(H, kv_heads, hd).contiguous()},
                "v_proj": {"kernel": get(f"{p}.self_attn.v_proj.weight").t().reshape(H, kv_heads, hd).contiguous()},
                "o_proj": {"kernel": get(f"{p}.self_attn.o_proj.weight").t().reshape(heads, hd, H).contiguous()},
            },
            "mlp": {
                "gate_proj": {"kernel": get(f"{p}.mlp.gate_proj.weight").t().contiguous()},
                "up_proj": {"kernel": get(f"{p}.mlp.up_proj.weight").t().contiguous()},
                "down_proj": {"kernel": get(f"{p}.mlp.down_proj.weight").t().contiguous()},
            },
        }
    return params


def config_from_hf(hf_config, **overrides) -> LlamaConfig:
    """A ``LlamaConfig`` from a ``transformers`` Llama config."""
    return LlamaConfig(
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        intermediate_size=hf_config.intermediate_size,
        max_position_embeddings=hf_config.max_position_embeddings,
        rms_norm_eps=hf_config.rms_norm_eps,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        **overrides,
    )


class HFTokenizer:
    """encode/decode over a ``transformers`` tokenizer (special tokens skipped
    in decode), the CLIs' ``HFTok``."""

    def __init__(self, tok):
        self.tok = tok

    def encode(self, text):
        return self.tok.encode(text)

    def decode(self, ids):
        return self.tok.decode(ids, skip_special_tokens=True)


def load_hf_llama(path: str, **config_overrides):
    """A LOCAL HF Llama directory (weights + tokenizer) -> (params, config,
    tokenizer, eos id); nothing is fetched (``local_files_only``).  Needs
    ``transformers``."""
    from transformers import AutoConfig, AutoTokenizer, LlamaForCausalLM

    config = config_from_hf(AutoConfig.from_pretrained(path, local_files_only=True), **config_overrides)
    with torch.no_grad():
        hf_model = LlamaForCausalLM.from_pretrained(path, local_files_only=True)
        params = hf_llama_to_port(hf_model.state_dict(), config)
    del hf_model
    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    return params, config, HFTokenizer(tok), tok.eos_token_id
