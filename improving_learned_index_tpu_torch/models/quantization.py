"""Weight-only int8/int4 quantization for decoder parameter trees.

Counterpart of ``improving_learned_index_tpu/models/quantization.py``, with
the same bytes: per-output-channel symmetric int8 (``W ~= q * s``, the scale
``amax / 127`` over axis 0, the contracted axis of every Dense kernel, 1 where
a channel is all zero) and packed int4 (``q`` in [-7, 7] biased to [0, 14],
split-half packed along axis 0: low nibbles hold rows [0, K/2), high nibbles
rows [K/2, K); an odd K falls back to int8 for that leaf).  Quantized leaves
are ``{"q": int8, "s": fp32}`` and ``{"q4": uint8, "s": fp32}`` dicts;
leaves of fewer than 2 axes and embeddings stay full precision.

Quantization runs in torch on whatever device holds the tree (fp32
arithmetic, round half to even, as numpy); ``dequantize_params`` rebuilds
full-precision leaves in a compute dtype with the JAX package's operations
in that dtype (``q * s``; the int4 float-math nibble decode), and the decoder
calls it on one sub-module's subtree at a time.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "s"}


def _is_q4leaf(x) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q4", "s"}


def _map(fn: Callable, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a nested dict, quantized leaves taken whole."""
    if isinstance(tree, dict) and not (_is_qleaf(tree) or _is_q4leaf(tree)):
        return {k: _map(fn, v, path + (str(k),)) for k, v in tree.items()}
    return fn(path, tree)


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf, order="C"))


def _is_quantizable(path: Tuple[str, ...], leaf: torch.Tensor) -> bool:
    return leaf.dim() >= 2 and "embed" not in "/".join(path).lower()


def _quantize_leaf_int8(leaf: torch.Tensor) -> dict:
    x = leaf.to(torch.float32)
    amax = x.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def _quantize_leaf_int4(leaf: torch.Tensor) -> dict:
    if leaf.shape[0] % 2:
        return _quantize_leaf_int8(leaf)
    x = leaf.to(torch.float32)
    amax = x.abs().amax(dim=0)
    scale = torch.where(amax > 0, amax / 7.0, torch.ones_like(amax))
    q = (torch.clamp(torch.round(x / scale), -7, 7) + 7).to(torch.uint8)
    half = leaf.shape[0] // 2
    return {"q4": q[:half] | (q[half:] << 4), "s": scale}


def _quantizer(leaf_fn):
    def quantize(params: Any) -> Any:
        def quant(path, leaf):
            if _is_qleaf(leaf) or _is_q4leaf(leaf):
                return leaf
            leaf = _as_tensor(leaf)
            return leaf_fn(leaf) if _is_quantizable(path, leaf) else leaf

        with torch.no_grad():
            return _map(quant, params)

    return quantize


quantize_params_int8 = _quantizer(_quantize_leaf_int8)
quantize_params_int8.__doc__ = "fp tree -> tree with int8 ``{'q', 's'}`` leaves (embeddings and 1-D leaves kept)."
quantize_params_int4 = _quantizer(_quantize_leaf_int4)
quantize_params_int4.__doc__ = "fp tree -> tree with packed int4 ``{'q4', 's'}`` leaves (int8 for an odd axis 0)."


def _unpack_int4(x: dict, dtype: torch.dtype) -> torch.Tensor:
    s = x["s"].to(dtype)
    f = x["q4"].to(torch.uint8).to(dtype)
    hi = torch.floor(f * (1.0 / 16.0))  # high nibble, biased [0, 14]
    lo = f - hi * 16.0                # low nibble, biased [0, 14]
    return torch.cat([((lo - 7.0) * s).to(dtype), ((hi - 7.0) * s).to(dtype)], dim=0)


def dequantize_params(qparams: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Quantized tree (int8 or packed int4 leaves, or one such leaf) -> full
    precision in ``dtype``; other leaves pass through unchanged."""
    def dq(path, x):
        if _is_qleaf(x):
            return (x["q"].to(dtype) * x["s"].to(dtype)).to(dtype)
        if _is_q4leaf(x):
            return _unpack_int4(x, dtype)
        return x

    return _map(dq, qparams)


def random_quantized_like_config(config, rng: np.random.Generator, device=None) -> Any:
    """A random int8 Llama tree built directly (no fp parent), from the same
    numpy draws as the JAX function: the same bytes for the same ``rng``.
    For memory and speed checks of geometries whose fp32 weights do not fit."""
    from .llama import LlamaConfig

    assert isinstance(config, LlamaConfig)
    c = config
    hd = c.head_dim

    def t(a):
        return torch.from_numpy(a).to(device)

    def qmat(*shape):
        return {
            "q": t(rng.integers(-127, 128, shape, dtype=np.int8)),
            "s": t(np.full(shape[1:], 0.01 / np.sqrt(shape[0]), dtype=np.float32)),
        }

    params = {
        "embed_tokens": {
            "embedding": t((rng.standard_normal((c.vocab_size, c.hidden_size)) * 0.02).astype(np.float32))
        },
        "norm": {"scale": t(np.ones(c.hidden_size, np.float32))},
    }
    for i in range(c.num_layers):
        params[f"layer_{i}"] = {
            "input_norm": {"scale": t(np.ones(c.hidden_size, np.float32))},
            "post_attn_norm": {"scale": t(np.ones(c.hidden_size, np.float32))},
            "attention": {
                "q_proj": {"kernel": qmat(c.hidden_size, c.num_heads, hd)},
                "k_proj": {"kernel": qmat(c.hidden_size, c.num_kv_heads, hd)},
                "v_proj": {"kernel": qmat(c.hidden_size, c.num_kv_heads, hd)},
                "o_proj": {"kernel": qmat(c.num_heads, hd, c.hidden_size)},
            },
            "mlp": {
                "gate_proj": {"kernel": qmat(c.hidden_size, c.intermediate_size)},
                "up_proj": {"kernel": qmat(c.hidden_size, c.intermediate_size)},
                "down_proj": {"kernel": qmat(c.intermediate_size, c.hidden_size)},
            },
        }
    if not c.tie_word_embeddings:
        params["lm_head"] = {"kernel": qmat(c.hidden_size, c.vocab_size)}
    return params
