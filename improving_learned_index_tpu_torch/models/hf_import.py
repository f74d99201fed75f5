"""Weights across: the JAX package's flax parameter tree, or a HuggingFace
BERT/RoBERTa/XLM-R state dict, into the port's ``DeepImpactModel``
``state_dict``.

Counterpart of ``improving_learned_index_tpu/models/hf_import.py``.  Weights
are re-laid-out, never re-trained: flax ``Dense`` kernels are [in, out] and
torch ``Linear`` weights [out, in]; the flax attention projections are
[H, heads, hd] (q, k, v) and [heads, hd, H] (output), flattened here to
[H, H] in the same (head, dim) order.

- ``flax_params_to_port(params, config)``: the JAX package's parameter tree
  (numpy leaves) of ``DeepImpactModel``, ``CrossEncoderModel`` (the same
  keys) or ``PairwiseImpactModel`` (plus ``pairwise_head``) -> the port's
  ``state_dict``.  The tests carry weights across with it.
- ``hf_deep_impact_to_port(state_dict, config)``: an HF-format state dict
  (``bert.``/``roberta.`` prefixes stripped, reference head keys
  ``impact_score_encoder.0``) -> the port's ``state_dict``; without head
  keys the head is the same seeded numpy draw as ``hf_deep_impact_to_flax``.
- ``load_hf_checkpoint(path, config)``: a local directory's
  ``pytorch_model.bin`` (read with ``weights_only=True``, no
  ``transformers``).  It gives what the JAX package's ``load_hf_checkpoint``
  gives: that route goes through ``AutoModel``, whose state dict has no
  ``impact_score_encoder.*``, so its head is always the seeded one -- here
  too.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..core.config import EncoderConfig

_HEAD_KEY = "impact_score_encoder.0"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _tensors(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def flax_params_to_port(params: Dict[str, Any], config: EncoderConfig) -> Dict[str, torch.Tensor]:
    """A JAX ``DeepImpactModel`` / ``CrossEncoderModel`` /
    ``PairwiseImpactModel`` parameter tree -> the port's state dict."""
    H = config.hidden_size
    enc = params["encoder"]
    emb = enc["embeddings"]
    sd: Dict[str, np.ndarray] = {
        "encoder.embeddings.word_embeddings.weight": _np(emb["word_embeddings"]["embedding"]),
        "encoder.embeddings.position_embeddings.weight": _np(emb["position_embeddings"]["embedding"]),
        "encoder.embeddings.token_type_embeddings.weight": _np(emb["token_type_embeddings"]["embedding"]),
        "encoder.embeddings.layer_norm.weight": _np(emb["layer_norm"]["scale"]),
        "encoder.embeddings.layer_norm.bias": _np(emb["layer_norm"]["bias"]),
    }
    for i in range(config.num_layers):
        L = enc[f"layer_{i}"]
        p = f"encoder.layers.{i}"
        for name in ("query", "key", "value"):
            sd[f"{p}.attention.{name}.weight"] = _np(L["attention"][name]["kernel"]).reshape(H, H).T
            sd[f"{p}.attention.{name}.bias"] = _np(L["attention"][name]["bias"]).reshape(H)
        out = L["attention"]["output_dense"]
        sd[f"{p}.attention.output_dense.weight"] = _np(out["kernel"]).reshape(H, H).T
        sd[f"{p}.attention.output_dense.bias"] = _np(out["bias"])
        for name in ("intermediate", "output"):
            sd[f"{p}.{name}.weight"] = _np(L[name]["kernel"]).T
            sd[f"{p}.{name}.bias"] = _np(L[name]["bias"])
        for name in ("attention_norm", "output_norm"):
            sd[f"{p}.{name}.weight"] = _np(L[name]["scale"])
            sd[f"{p}.{name}.bias"] = _np(L[name]["bias"])
    head = params["impact_head"]["dense"]
    sd["impact_head.dense.weight"] = _np(head["kernel"]).T
    sd["impact_head.dense.bias"] = _np(head["bias"])
    if "pairwise_head" in params:  # flax Dense(1): kernel [2H+1, 1]
        sd["pairwise_head.weight"] = _np(params["pairwise_head"]["kernel"]).T
        sd["pairwise_head.bias"] = _np(params["pairwise_head"]["bias"])
    return _tensors(sd)


def _strip_prefix(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Normalize key prefixes: the trunk may live under bert./roberta./none."""
    out = {k: _np(v) for k, v in state.items()}
    for prefix in ("bert.", "roberta."):
        if any(k.startswith(prefix + "embeddings") for k in out):
            return {(k[len(prefix):] if k.startswith(prefix) else k): v for k, v in out.items()}
    return out


def hf_deep_impact_to_port(
    state_dict: Dict[str, Any],
    config: EncoderConfig,
    head_key: str = _HEAD_KEY,
    seed: int = 0,
) -> Dict[str, torch.Tensor]:
    """HF-format DeepImpact state dict -> the port's state dict.  Torch
    ``Linear`` weights keep their [out, in] layout; the head is initialized
    from ``np.random.default_rng(seed)`` (Glorot-uniform limit, zero bias)
    when ``head_key`` is absent, as ``hf_deep_impact_to_flax`` does."""
    sd = _strip_prefix(state_dict)
    out: Dict[str, np.ndarray] = {
        "encoder.embeddings.word_embeddings.weight": sd["embeddings.word_embeddings.weight"],
        "encoder.embeddings.position_embeddings.weight": sd["embeddings.position_embeddings.weight"],
        "encoder.embeddings.token_type_embeddings.weight": sd["embeddings.token_type_embeddings.weight"],
        "encoder.embeddings.layer_norm.weight": sd["embeddings.LayerNorm.weight"],
        "encoder.embeddings.layer_norm.bias": sd["embeddings.LayerNorm.bias"],
    }
    names = {
        "attention.query": "attention.self.query",
        "attention.key": "attention.self.key",
        "attention.value": "attention.self.value",
        "attention.output_dense": "attention.output.dense",
        "attention_norm": "attention.output.LayerNorm",
        "intermediate": "intermediate.dense",
        "output": "output.dense",
        "output_norm": "output.LayerNorm",
    }
    for i in range(config.num_layers):
        for ours, theirs in names.items():
            for part in ("weight", "bias"):
                out[f"encoder.layers.{i}.{ours}.{part}"] = sd[f"encoder.layer.{i}.{theirs}.{part}"]
    wkey, bkey = f"{head_key}.weight", f"{head_key}.bias"
    if wkey in sd:
        out["impact_head.dense.weight"] = sd[wkey]
        out["impact_head.dense.bias"] = sd[bkey]
    else:
        rng = np.random.default_rng(seed)
        limit = float(np.sqrt(6.0 / (config.hidden_size + 1)))
        kernel = rng.uniform(-limit, limit, (config.hidden_size, 1)).astype(np.float32)
        out["impact_head.dense.weight"] = kernel.T
        out["impact_head.dense.bias"] = np.zeros((1,), dtype=np.float32)
    return _tensors(out)


def load_hf_checkpoint(
    path: Union[str, Path], config: Optional[EncoderConfig] = None
) -> Dict[str, torch.Tensor]:
    """The port's state dict from a local HF directory's ``pytorch_model.bin``.

    ``config`` is required (the JAX route reads it from the directory's
    ``config.json`` through ``transformers``, which the port does not use).
    The head is always the seeded one, as on the JAX route (see the module
    docstring).  A hub id or a directory without ``pytorch_model.bin`` (for
    example safetensors only) raises.
    """
    d = Path(path)
    weights = d / "pytorch_model.bin"
    if not d.is_dir() or not weights.exists():
        raise ValueError(
            f"{path}: need a local directory holding pytorch_model.bin (the port reads no "
            "hub ids and no safetensors-only checkpoints)"
        )
    if config is None:
        raise ValueError("load_hf_checkpoint needs the EncoderConfig of the checkpoint")
    state = torch.load(weights, map_location="cpu", weights_only=True)
    trunk = {k: v for k, v in state.items() if not k.startswith(_HEAD_KEY)}
    return hf_deep_impact_to_port(trunk, config)
