"""LoRA: low-rank adapters for the doc2query decoder.

Counterpart of ``improving_learned_index_tpu/expand/lora.py`` (the
reference's peft r=16, alpha=32 on the 7 projection matrices and its
``merge_and_unload``).  Adapters are a separate tree beside the decoder's
parameter tree: ``{path: {"kernel": {"lora_a": [in, r], "lora_b": [r,
out]}}}`` in fp32, ``lora_b`` zero at init, factored on the 2-D view of a
kernel that balances in and out (``_factor_dims``: q/k/v ``[hidden, heads,
hd]`` as ``[hidden, heads * hd]``, o_proj ``[heads, hd, hidden]`` as ``[heads
* hd, hidden]``).  ``merge_lora`` returns ``W + scaling * (A @ B)`` reshaped
to W, in W's dtype; under autograd the merged tree is differentiable in the
adapters, and ``lora_forward_params`` detaches the base.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

DEFAULT_TARGETS = (
    "q_proj",
    "k_proj",
    "v_proj",
    "o_proj",
    "gate_proj",
    "up_proj",
    "down_proj",
)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 16
    alpha: int = 32
    targets: Sequence[str] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.r


def _target_paths(params: Dict[str, Any], targets: Sequence[str]) -> List[Tuple[str, ...]]:
    """Paths of the kernels under a target name, in the tree's order (a
    quantized leaf is a dict, so it is never a ``kernel`` leaf)."""
    paths = []

    def visit(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v, path + (str(k),))
            elif k == "kernel" and any(t in path for t in targets):
                paths.append(path + (k,))

    visit(params, ())
    return paths


def _factor_dims(shape: Sequence[int]) -> Tuple[int, int]:
    """(in_dim, out_dim) of the 2-D view that minimizes in_dim + out_dim."""
    best = min(range(1, len(shape)), key=lambda k: math.prod(shape[:k]) + math.prod(shape[k:]))
    return math.prod(shape[:best]), math.prod(shape[best:])


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def init_lora_params(params: Dict[str, Any], config: LoraConfig, seed: int = 0,
                     device=None) -> Dict[str, Any]:
    """A zero ``lora_b`` and a N(0, 0.01^2) ``lora_a`` per target kernel, drawn
    on the CPU from ``seed`` (the same adapters on every device) and moved to
    ``device``."""
    gen = torch.Generator().manual_seed(seed)
    lora: Dict[str, Any] = {}
    for path in _target_paths(params, config.targets):
        in_dim, out_dim = _factor_dims(tuple(_get(params, path).shape))
        node = lora
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node["kernel"] = {
            "lora_a": (torch.randn(in_dim, config.r, generator=gen) * 0.01).to(device),
            "lora_b": torch.zeros(config.r, out_dim, device=device),
        }
    return lora


def merge_lora(params: Dict[str, Any], lora: Optional[Dict[str, Any]], config: LoraConfig) -> Dict[str, Any]:
    """W' = W + scaling * A @ B (peft merge_and_unload semantics); leaves
    without an adapter pass through."""
    def merge(node, adapters):
        out = {}
        for k, v in node.items():
            a = adapters.get(k) if isinstance(adapters, dict) else None
            if a is None:
                out[k] = v
            elif isinstance(v, dict):
                out[k] = merge(v, a)
            else:
                delta = (a["lora_a"] @ a["lora_b"]) * config.scaling
                out[k] = v + delta.reshape(v.shape).to(v.dtype)
        return out

    return merge(params, lora or {})


def lora_forward_params(params: Dict[str, Any], lora: Dict[str, Any], config: LoraConfig) -> Dict[str, Any]:
    """Merged params differentiable in ``lora`` only (the base detached)."""
    from ..models.llama import tree_map

    return merge_lora(tree_map(lambda t: t.detach(), params), lora, config)


def lora_leaves(lora: Dict[str, Any]) -> List[torch.Tensor]:
    """The adapter tensors in the tree's order (the optimizer's parameters)."""
    out = []
    for v in lora.values():
        out.extend(lora_leaves(v) if isinstance(v, dict) else [v])
    return out
