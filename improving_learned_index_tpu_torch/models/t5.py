"""T5 / mT5 encoder-decoder (PyTorch ``nn.Module``s) -- the second doc2query
model family.

Counterpart of ``improving_learned_index_tpu/models/t5.py`` (the reference's
``doc2query/msmarco-vietnamese-mt5-base-v1`` expansion path): HF T5 v1.1 /
mT5 with an RMS-style LayerNorm (no mean, no bias), the bucketed relative
position bias of the first layer shared by every layer, **unscaled**
attention logits, a gated-GELU feed-forward (ReLU for v1.0) and an optional
tied head with v1.0's ``d_model**-0.5`` logit scale.  The decoder takes a
static-shape self-attention KV cache and cross-attention K/V computed once
from the encoder output.

Parameters keep the flax tree's names and layouts, so a JAX parameter tree
carries across leaf for leaf (``t5_flax_params_to_port``): Dense kernels are
``[in, out]``, ``q/k/v`` ``[d_model, heads, d_kv]``, ``o`` ``[heads, d_kv,
d_model]``; the top-level names are ``shared``, ``encoder_layer_{i}``,
``decoder_layer_{i}``, ``encoder_final_norm``, ``decoder_final_norm``,
``encoder_rel_bias``, ``decoder_rel_bias`` and ``lm_head``.

Precision follows the JAX module: the residual stream is in the compute
dtype, each LayerNorm squares and takes ``rsqrt`` in fp32 and casts back;
the attention logits are the compute-dtype product cast to fp32, the fp32
bias added, the softmax fp32 and the probabilities cast back before
``probs @ v``; the encoder output is fp32 (the cross K/V come from it through
the compute-dtype projections, the cross bias is the padding mask alone);
the head is fp32 with an fp32 kernel (TF32 stays off).  The relative
position buckets copy the JAX formula (``1e-6`` inside the ``log``, which HF
leaves out) and are computed on the host, in fp32 on the CPU, whatever the
device: the card's ``log`` may round otherwise at a bucket edge.

``T5Model``'s methods take ``params=tree`` to run on a parameter tree in
place of the module's own parameters: each sub-module's subtree is
dequantized in fp32 (int8 ``{"q", "s"}`` and packed-int4 ``{"q4", "s"}``
leaves, as the JAX T5 sampler dequantizes) right before that sub-module
runs.  Build the module on the ``meta`` device to hold no weights of its
own.  The attention reaches no kernel: the JAX package runs it as XLA
einsums, the port as plain torch ops.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .encoder import compute_dtype
from .llama import (
    Dense, Embed, HFTokenizer, RMSNorm, _cache_update, _call, _check_tree, _map_shapes, _to_torch, tree_map,
)
from .quantization import dequantize_params

F32 = torch.float32
NEG = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 250112  # mT5
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 2048
    num_encoder_layers: int = 12
    num_decoder_layers: int = 12
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_eps: float = 1e-6
    gated_act: bool = True  # v1.1/mT5 gated-gelu; False = v1.0 relu
    tie_word_embeddings: bool = False  # True = v1.0 (scales logits)
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(vocab_size: int = 256) -> "T5Config":
        return T5Config(vocab_size=vocab_size, d_model=64, d_kv=16, num_heads=4, d_ff=128,
                        num_encoder_layers=2, num_decoder_layers=2)

    @staticmethod
    def mt5_base() -> "T5Config":
        """google/mt5-base's published config."""
        return T5Config()


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """HF T5 bucketing with the JAX package's ``1e-6`` inside the ``log``;
    int32 buckets on ``relative_position``'s device."""
    rel = relative_position.to(torch.int32)
    ret = torch.zeros_like(rel)
    n = -rel
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(torch.int32) * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    scaled = torch.log(n.to(F32) / max_exact + 1e-6) / np.float32(np.log(max_distance / max_exact))
    val_if_large = max_exact + (scaled * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def _bucket_table(q_start: int, q_len: int, k_len: int, bidirectional: bool, num_buckets: int,
                  max_distance: int) -> torch.Tensor:
    """[q_len, k_len] int64 buckets of queries at ``q_start ..`` against keys
    at ``0 ..``, computed on the CPU."""
    q_pos = torch.arange(q_start, q_start + q_len, dtype=torch.int32)
    k_pos = torch.arange(k_len, dtype=torch.int32)
    rel = k_pos[None, :] - q_pos[:, None]
    return relative_position_bucket(rel, bidirectional, num_buckets, max_distance).to(torch.int64)


T5LayerNorm = RMSNorm  # scale-only RMS norm in fp32, cast back to the input's dtype


class T5Attention(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        c = config
        self.config = c
        self.q = Dense((c.d_model,), (c.num_heads, c.d_kv), device)
        self.k = Dense((c.d_model,), (c.num_heads, c.d_kv), device)
        self.v = Dense((c.d_model,), (c.num_heads, c.d_kv), device)
        self.o = Dense((c.num_heads, c.d_kv), (c.d_model,), device)

    def forward(self, x, kv_source, attention_bias, kv_cache=None, cache_index=None, static_kv=None):
        """``kv_source``: ``x`` for self-attention, the encoder output for
        cross-attention (or ``static_kv``, its precomputed K/V);
        ``attention_bias`` [B or 1, heads, Lq, Lk] additive fp32;
        ``kv_cache`` (k, v) [B, S, heads, d_kv], written at ``cache_index``
        in place."""
        dt = compute_dtype(self.config)
        q = self.q(x, dt)
        if static_kv is not None:
            k, v = static_kv
        else:
            k, v = self.k(kv_source, dt), self.v(kv_source, dt)
            if kv_cache is not None:
                k = _cache_update(kv_cache[0], k, cache_index)
                v = _cache_update(kv_cache[1], v, cache_index)
                kv_cache = (k, v)
        # T5: NO 1/sqrt(d) scaling
        logits = torch.matmul(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)).to(F32)
        probs = torch.softmax(logits + attention_bias, dim=-1).to(dt)
        ctx = torch.matmul(probs, v.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
        return self.o(ctx, dt), kv_cache


class T5FF(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        c = config
        self.config = c
        if c.gated_act:
            self.wi_0 = Dense((c.d_model,), (c.d_ff,), device)
            self.wi_1 = Dense((c.d_model,), (c.d_ff,), device)
        else:
            self.wi = Dense((c.d_model,), (c.d_ff,), device)
        self.wo = Dense((c.d_ff,), (c.d_model,), device)

    def forward(self, x):
        dt = compute_dtype(self.config)
        if self.config.gated_act:
            h = F.gelu(self.wi_0(x, dt), approximate="tanh") * self.wi_1(x, dt)
        else:
            h = torch.relu(self.wi(x, dt))
        return self.wo(h, dt)


class T5EncoderLayer(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        c = config
        self.self_attention = T5Attention(c, device)
        self.self_norm = T5LayerNorm(c.d_model, c.layer_norm_eps, device)
        self.ff = T5FF(c, device)
        self.ff_norm = T5LayerNorm(c.d_model, c.layer_norm_eps, device)

    def forward(self, x, attention_bias):
        normed = self.self_norm(x)
        h, _ = self.self_attention(normed, normed, attention_bias)
        x = x + h
        return x + self.ff(self.ff_norm(x))


class T5DecoderLayer(nn.Module):
    def __init__(self, config: T5Config, device=None):
        super().__init__()
        c = config
        self.self_attention = T5Attention(c, device)
        self.self_norm = T5LayerNorm(c.d_model, c.layer_norm_eps, device)
        self.cross_attention = T5Attention(c, device)
        self.cross_norm = T5LayerNorm(c.d_model, c.layer_norm_eps, device)
        self.ff = T5FF(c, device)
        self.ff_norm = T5LayerNorm(c.d_model, c.layer_norm_eps, device)

    def forward(self, x, self_bias, cross_bias, encoder_output=None, kv_cache=None, cache_index=None,
                cross_kv=None):
        normed = self.self_norm(x)
        h, kv_cache = self.self_attention(normed, normed, self_bias, kv_cache=kv_cache, cache_index=cache_index)
        x = x + h
        h, _ = self.cross_attention(self.cross_norm(x), encoder_output, cross_bias, static_kv=cross_kv)
        x = x + h
        return x + self.ff(self.ff_norm(x)), kv_cache


class T5Model(nn.Module):
    """The encoder-decoder.  ``encode(ids, mask)`` -> fp32 hidden states;
    ``decode(decoder_ids, encoder_output, encoder_mask, kv_caches=,
    cache_index=, cross_kvs=)`` -> fp32 logits and the caches (updated in
    place; ``None`` without caches); ``compute_cross_kvs(encoder_output)``;
    ``forward`` = encode + decode (teacher forcing).  Every method takes
    ``params=tree``."""

    def __init__(self, config: T5Config, device=None):
        super().__init__()
        c = config
        self.config = c
        self.shared = Embed(c.vocab_size, c.d_model, device)
        for i in range(c.num_encoder_layers):
            self.add_module(f"encoder_layer_{i}", T5EncoderLayer(c, device))
        self.encoder_final_norm = T5LayerNorm(c.d_model, c.layer_norm_eps, device)
        self.encoder_rel_bias = Embed(c.relative_attention_num_buckets, c.num_heads, device)
        for i in range(c.num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", T5DecoderLayer(c, device))
        self.decoder_final_norm = T5LayerNorm(c.d_model, c.layer_norm_eps, device)
        self.decoder_rel_bias = Embed(c.relative_attention_num_buckets, c.num_heads, device)
        if not c.tie_word_embeddings:
            self.lm_head = Dense((c.d_model,), (c.vocab_size,), device)

    def _run(self, name: str, params, *args):
        """Sub-module ``name`` on ``params[name]`` (dequantized in fp32) or on
        its own parameters."""
        return _call(getattr(self, name), None if params is None else params[name], F32, *args)

    def _rel_bias(self, name: str, q_start: int, q_len: int, k_len: int, bidirectional: bool, params,
                  device) -> torch.Tensor:
        """[1, heads, q_len, k_len] fp32 position bias (host-built buckets)."""
        c = self.config
        buckets = _bucket_table(q_start, q_len, k_len, bidirectional, c.relative_attention_num_buckets,
                                c.relative_attention_max_distance).to(device)
        return self._run(name, params, buckets).permute(2, 0, 1)[None].to(F32)

    def encode(self, input_ids, attention_mask, params: Optional[Dict[str, Any]] = None) -> torch.Tensor:
        c = self.config
        x = self._run("shared", params, input_ids).to(compute_dtype(c))
        length = input_ids.shape[1]
        bias = self._rel_bias("encoder_rel_bias", 0, length, length, True, params, input_ids.device)
        bias = bias + torch.where(attention_mask[:, None, None, :].bool(), 0.0, NEG).to(F32)
        for i in range(c.num_encoder_layers):
            x = self._run(f"encoder_layer_{i}", params, x, bias)
        return self._run("encoder_final_norm", params, x).to(F32)

    def _logits(self, x, params) -> torch.Tensor:
        c = self.config
        x = x.to(F32)
        if c.tie_word_embeddings:
            x = x * (c.d_model ** -0.5)  # v1.0 scaling
            emb = params["shared"]["embedding"] if params is not None else self.shared.embedding
            emb = dequantize_params(emb, F32) if isinstance(emb, dict) else emb
            return torch.matmul(x, emb.to(F32).t())
        return self._run("lm_head", params, x, F32)

    def decoder_self_bias(self, q_start: int, q_len: int, k_len: int, params, device) -> torch.Tensor:
        """[1, heads, q_len, k_len] fp32 self-attention bias of decoder
        queries at ``q_start ..`` against keys (or cache slots) at ``0 ..``:
        the position bias where a key is at or before its query, ``NEG``
        elsewhere."""
        bias = self._rel_bias("decoder_rel_bias", q_start, q_len, k_len, False, params, device)
        q_pos = torch.arange(q_start, q_start + q_len, device=device)
        valid = torch.arange(k_len, device=device)[None, :] <= q_pos[:, None]  # causal / filled slots
        return torch.where(valid[None, None], bias, NEG)

    def decode(self, decoder_input_ids, encoder_output, encoder_mask, kv_caches=None, cache_index=None,
               cross_kvs=None, params: Optional[Dict[str, Any]] = None, self_bias=None):
        """``self_bias``: ``decoder_self_bias``'s rows of these queries, when
        the caller has built them once for every step."""
        c = self.config
        dev = decoder_input_ids.device
        x = self._run("shared", params, decoder_input_ids).to(compute_dtype(c))
        if self_bias is None:
            qlen = decoder_input_ids.shape[1]
            if kv_caches is None:
                q_start, k_len = 0, qlen
            else:
                q_start, k_len = int(cache_index), kv_caches[0][0].shape[1]
            self_bias = self.decoder_self_bias(q_start, qlen, k_len, params, dev)
        cross_bias = torch.where(encoder_mask[:, None, None, :].bool(), 0.0, NEG).to(F32)
        new_caches = []
        for i in range(c.num_decoder_layers):
            cache_i = kv_caches[i] if kv_caches is not None else None
            cross_kv_i = cross_kvs[i] if cross_kvs is not None else None
            x, new_cache = self._run(f"decoder_layer_{i}", params, x, self_bias, cross_bias, encoder_output,
                                     cache_i, cache_index, cross_kv_i)
            new_caches.append(new_cache)
        x = self._run("decoder_final_norm", params, x)
        return self._logits(x, params), (new_caches if kv_caches is not None else None)

    def compute_cross_kvs(self, encoder_output, params: Optional[Dict[str, Any]] = None) -> List[Tuple]:
        """Per decoder layer, the cross-attention (K, V) of the encoder output
        in the compute dtype, once per prompt."""
        dt = compute_dtype(self.config)
        out = []
        for i in range(self.config.num_decoder_layers):
            attn = getattr(self, f"decoder_layer_{i}").cross_attention
            sub = None if params is None else params[f"decoder_layer_{i}"]["cross_attention"]
            out.append(tuple(_call(getattr(attn, n), None if sub is None else sub[n], F32, encoder_output, dt)
                             for n in ("k", "v")))
        return out

    def forward(self, input_ids, attention_mask, decoder_input_ids, params: Optional[Dict[str, Any]] = None):
        enc = self.encode(input_ids, attention_mask, params=params)
        logits, _ = self.decode(decoder_input_ids, enc, attention_mask, params=params)
        return logits


def make_t5_kv_caches(config: T5Config, batch: int, max_len: int, device=None) -> list:
    """Per decoder layer, zero (k, v) caches [batch, max_len, heads, d_kv] in
    the compute dtype."""
    dtype = compute_dtype(config)
    shape = (batch, max_len, config.num_heads, config.d_kv)
    return [(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(config.num_decoder_layers)]


# -- parameter trees -----------------------------------------------------------


def t5_param_shapes(config: T5Config) -> Dict[str, Any]:
    """The flax parameter tree's shapes (nested dicts of tuples)."""
    c = config
    H, h, d = c.d_model, c.num_heads, c.d_kv

    def attn():
        return {"q": {"kernel": (H, h, d)}, "k": {"kernel": (H, h, d)}, "v": {"kernel": (H, h, d)},
                "o": {"kernel": (h, d, H)}}

    def ff():
        wi = {"wi_0": {"kernel": (H, c.d_ff)}, "wi_1": {"kernel": (H, c.d_ff)}} if c.gated_act \
            else {"wi": {"kernel": (H, c.d_ff)}}
        return {**wi, "wo": {"kernel": (c.d_ff, H)}}

    nb = c.relative_attention_num_buckets
    shapes: Dict[str, Any] = {
        "shared": {"embedding": (c.vocab_size, H)},
        "encoder_final_norm": {"scale": (H,)},
        "decoder_final_norm": {"scale": (H,)},
        "encoder_rel_bias": {"embedding": (nb, h)},
        "decoder_rel_bias": {"embedding": (nb, h)},
    }
    if not c.tie_word_embeddings:
        shapes["lm_head"] = {"kernel": (H, c.vocab_size)}
    for i in range(c.num_encoder_layers):
        shapes[f"encoder_layer_{i}"] = {"self_attention": attn(), "self_norm": {"scale": (H,)}, "ff": ff(),
                                        "ff_norm": {"scale": (H,)}}
    for i in range(c.num_decoder_layers):
        shapes[f"decoder_layer_{i}"] = {"self_attention": attn(), "self_norm": {"scale": (H,)},
                                        "cross_attention": attn(), "cross_norm": {"scale": (H,)}, "ff": ff(),
                                        "ff_norm": {"scale": (H,)}}
    return shapes


@torch.no_grad()
def init_t5_params(config: T5Config, seed: int = 0, device=None) -> Dict[str, Any]:
    """A random parameter tree with flax's initializer shapes and scales (not
    its numbers): embeddings and kernels truncated normal (2 sigma) with std
    1/sqrt(fan_in) (fan_in the embedding's width, the contracted axes of a
    kernel), norm scales 1.  Drawn on ``device`` from ``seed``, leaf by
    leaf, in fp32."""
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(seed)

    def draw(path, shape):
        if path[-1] == "scale":
            return torch.ones(shape, dtype=F32, device=device)
        fan_in = shape[1] if path[-1] == "embedding" else (shape[0] * shape[1] if path[-2] == "o" else shape[0])
        std = fan_in ** -0.5 / 0.87962566103423978
        leaf = torch.empty(shape, dtype=F32, device=device)
        return nn.init.trunc_normal_(leaf, 0.0, std, -2 * std, 2 * std, generator=gen)

    return _map_shapes(draw, t5_param_shapes(config))


def t5_flax_params_to_port(params: Dict[str, Any], config: Optional[T5Config] = None) -> Dict[str, Any]:
    """The JAX package's T5 parameter tree (numpy leaves, as
    ``jax.device_get`` gives it; quantized ``{"q", "s"}`` / ``{"q4", "s"}``
    leaves too) as the port's tree of CPU tensors: the same names, layouts
    and dtypes (checked against ``config`` when given)."""
    tree = tree_map(_to_torch, params)
    if config is not None:
        _check_tree(tree, t5_param_shapes(config))
    return tree


def hf_t5_to_port(state_dict: Dict[str, Any], config: T5Config) -> Dict[str, Any]:
    """An HF ``T5ForConditionalGeneration`` (or MT5) state dict as the port's
    tree (fp32 CPU tensors), the layout ``hf_t5_to_flax`` gives.  Both
    stacks embed with ``shared.weight``: a state dict whose
    ``encoder.embed_tokens.weight`` or ``decoder.embed_tokens.weight``
    differs from it (``transformers`` 5 keeps such tables untied) is
    refused."""

    def get(name):
        t = state_dict[name]
        t = t.detach().cpu() if isinstance(t, torch.Tensor) else torch.from_numpy(np.asarray(t))
        return t.to(F32)

    shared = get("shared.weight")
    for name in ("encoder.embed_tokens.weight", "decoder.embed_tokens.weight"):
        if name in state_dict and not torch.equal(get(name), shared):
            raise ValueError(f"{name} differs from shared.weight: the port embeds both stacks with shared.weight")

    H, heads, dkv = config.d_model, config.num_heads, config.d_kv

    def kernel(name, *shape):
        return {"kernel": get(name).t().reshape(*shape).contiguous()}

    def attn(prefix):
        return {"q": kernel(f"{prefix}.q.weight", H, heads, dkv), "k": kernel(f"{prefix}.k.weight", H, heads, dkv),
                "v": kernel(f"{prefix}.v.weight", H, heads, dkv), "o": kernel(f"{prefix}.o.weight", heads, dkv, H)}

    def ff(prefix):
        names = ("wi_0", "wi_1", "wo") if config.gated_act else ("wi", "wo")
        return {n: {"kernel": get(f"{prefix}.{n}.weight").t().contiguous()} for n in names}

    def scale(name):
        return {"scale": get(name).contiguous()}

    rel = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"
    params: Dict[str, Any] = {
        "shared": {"embedding": shared.contiguous()},
        "encoder_final_norm": scale("encoder.final_layer_norm.weight"),
        "decoder_final_norm": scale("decoder.final_layer_norm.weight"),
        "encoder_rel_bias": {"embedding": get(f"encoder.{rel}").contiguous()},
        "decoder_rel_bias": {"embedding": get(f"decoder.{rel}").contiguous()},
    }
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": get("lm_head.weight").t().contiguous()}
    for i in range(config.num_encoder_layers):
        p = f"encoder.block.{i}.layer"
        params[f"encoder_layer_{i}"] = {
            "self_attention": attn(f"{p}.0.SelfAttention"), "self_norm": scale(f"{p}.0.layer_norm.weight"),
            "ff": ff(f"{p}.1.DenseReluDense"), "ff_norm": scale(f"{p}.1.layer_norm.weight"),
        }
    for i in range(config.num_decoder_layers):
        p = f"decoder.block.{i}.layer"
        params[f"decoder_layer_{i}"] = {
            "self_attention": attn(f"{p}.0.SelfAttention"), "self_norm": scale(f"{p}.0.layer_norm.weight"),
            "cross_attention": attn(f"{p}.1.EncDecAttention"), "cross_norm": scale(f"{p}.1.layer_norm.weight"),
            "ff": ff(f"{p}.2.DenseReluDense"), "ff_norm": scale(f"{p}.2.layer_norm.weight"),
        }
    return params


def t5_config_from_hf(hf_config, tie_word_embeddings: bool) -> T5Config:
    """A ``T5Config`` from a ``transformers`` T5/MT5 config, field for field
    as the JAX CLI reads it (the compute dtype stays bf16), but for
    ``tie_word_embeddings``, given apart: ``transformers`` 5 sets the config
    object's flag to True for every T5 and MT5 config and keeps the
    checkpoint's own flag only as ``scale_decoder_outputs``, so
    ``load_hf_t5`` reads it from the directory's ``config.json``."""
    hc = hf_config
    return T5Config(
        vocab_size=hc.vocab_size, d_model=hc.d_model, d_kv=hc.d_kv, num_heads=hc.num_heads, d_ff=hc.d_ff,
        num_encoder_layers=hc.num_layers, num_decoder_layers=hc.num_decoder_layers,
        relative_attention_num_buckets=hc.relative_attention_num_buckets,
        relative_attention_max_distance=getattr(hc, "relative_attention_max_distance", 128),
        gated_act="gated" in hc.feed_forward_proj, tie_word_embeddings=bool(tie_word_embeddings),
    )


def load_hf_t5(path: str):
    """A LOCAL HF T5/mT5 directory (weights + tokenizer) -> (params, config,
    tokenizer, token ids): the ids are ``pad_token_id``,
    ``eos_token_id`` and ``decoder_start_token_id`` with the JAX CLI's
    ``or 0`` / ``or 1`` / ``or 0`` defaults; whether the head is tied comes
    from ``config.json`` (absent: tied, the T5 v1.0 default), whatever the
    ``transformers`` version.  A model whose stacks do not embed with
    ``shared`` is refused (``hf_t5_to_port``).  Nothing is fetched
    (``local_files_only``).  Needs ``transformers``."""
    from transformers import AutoConfig, AutoTokenizer, T5ForConditionalGeneration

    hc = AutoConfig.from_pretrained(path, local_files_only=True)
    declared = json.loads((Path(path) / "config.json").read_text(encoding="utf-8"))
    config = t5_config_from_hf(hc, tie_word_embeddings=declared.get("tie_word_embeddings", True))
    with torch.no_grad():
        hf_model = T5ForConditionalGeneration.from_pretrained(path, local_files_only=True)
        params = hf_t5_to_port(hf_model.state_dict(), config)
    del hf_model
    tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
    ids = {"pad_token_id": tok.pad_token_id or 0, "eos_token_id": tok.eos_token_id or 1,
           "decoder_start_token_id": hc.decoder_start_token_id or 0}
    return params, config, HFTokenizer(tok), ids
