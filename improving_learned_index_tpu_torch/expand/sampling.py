"""Autoregressive sampling with a static-shape KV cache.

Counterpart of ``improving_learned_index_tpu/expand/sampling.py`` (the
reference's HF ``generate`` with do_sample, top_k=50, top_p=0.95,
num_return_sequences=80, max_new_tokens=50): one prefill of the left-padded
prompts into caches of ``prompt_len + max_new_tokens`` slots, then one token
a step for every sequence until all have emitted EOS or the budget is spent.
``num_return_sequences`` tiles the prompt batch.  A parameter tree with
quantized leaves is dequantized at each use, one sub-module at a time, in
the prefill and in every step (``LlamaModel.forward(params=...)``).

Sampling draws from an explicit ``torch.Generator`` seeded per call (the
JAX package splits a PRNG key per step): Gumbel-max over the filtered
logits, which samples the same distribution as ``jax.random.categorical``
but not the same tokens.  Greedy decoding (``do_sample=False``) is argmax
and gives the JAX package's tokens.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..core.config import GenerationConfig
from ..models.llama import LlamaConfig, LlamaModel, make_kv_caches


def top_k_top_p_filter(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """HF semantics, the JAX function step for step: top-k first (logits below
    the k-th largest to -inf), then top-p keeps the smallest prefix of the
    sorted distribution whose cumulative probability before each token is
    below p (always the best token)."""
    vocab = logits.shape[-1]
    if 0 < top_k < vocab:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.flip(torch.sort(logits, dim=-1).values, dims=[-1])
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        kept = torch.where(keep_sorted, sorted_logits, float("inf"))
        threshold = kept.amin(dim=-1, keepdim=True)
        logits = torch.where(logits < threshold, float("-inf"), logits)
    return logits


def sample_token(logits: torch.Tensor, gen: GenerationConfig, generator: torch.Generator) -> torch.Tensor:
    """[B, V] fp32 logits -> [B] ids: argmax without ``do_sample``, else
    Gumbel-max over the temperature-scaled, top-k/top-p filtered logits."""
    if not gen.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = top_k_top_p_filter(logits / max(gen.temperature, 1e-6), gen.top_k, gen.top_p)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


class Sampler:
    """Prefill + step-by-step decode for a ``LlamaModel`` over a parameter
    tree (full precision or quantized) on the tree's device."""

    def __init__(self, config: LlamaConfig, gen: GenerationConfig, eos_token_id: int = 2):
        self.config = config
        self.gen = gen
        self.eos = eos_token_id
        self.module = LlamaModel(config, device="meta")

    def _sample(self, logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return sample_token(logits, self.gen, generator)

    @torch.no_grad()
    def run(self, params: Dict[str, Any], input_ids: torch.Tensor, attention_mask: torch.Tensor,
            generator: torch.Generator) -> torch.Tensor:
        """[B, max_new_tokens] int32 ids on the params' device: EOS after a
        sequence's EOS, 0 past the step at which every sequence had ended (the
        JAX loop's zero-initialized buffer)."""
        c, module, eos = self.config, self.module, self.eos
        max_new = self.gen.max_new_tokens
        dev = input_ids.device
        bsz, prompt_len = input_ids.shape
        caches = make_kv_caches(c, bsz, prompt_len + max_new, device=dev)
        # left-padded prompts: positions count only real tokens
        positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
        prompt_lens = attention_mask.sum(dim=1)
        slot_mask = torch.cat([attention_mask, torch.zeros(bsz, max_new, dtype=attention_mask.dtype,
                                                           device=dev)], dim=1)
        logits, caches = module(input_ids, slot_mask, positions, caches, 0, params=params)
        nxt = self._sample(logits[:, -1, :], generator).to(torch.int32)
        out = torch.zeros((bsz, max_new), dtype=torch.int32, device=dev)
        out[:, 0] = nxt
        finished = nxt == eos
        t = 1
        while t < max_new and not bool(finished.all()):
            cache_index = prompt_len + t - 1
            slot_mask[:, cache_index] = 1
            pos = (prompt_lens + t - 1)[:, None]
            logits, caches = module(out[:, t - 1:t], slot_mask, pos, caches, cache_index, params=params)
            nxt = self._sample(logits[:, 0, :], generator).to(torch.int32)
            nxt = torch.where(finished, eos, nxt)
            out[:, t] = nxt
            finished = finished | (nxt == eos)
            t += 1
        return out

    def generate(self, params: Dict[str, Any], input_ids: np.ndarray, attention_mask: np.ndarray,
                 num_return_sequences: int = 1, seed: int = 0) -> np.ndarray:
        """[B * num_return_sequences, max_new_tokens] ids (see ``run``);
        sequences i*k..(i+1)*k are the k samples for prompt i."""
        if num_return_sequences > 1:
            input_ids = np.repeat(input_ids, num_return_sequences, axis=0)
            attention_mask = np.repeat(attention_mask, num_return_sequences, axis=0)
        dev = _device_of(params)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        out = self.run(
            params,
            torch.as_tensor(np.asarray(input_ids, dtype=np.int64), device=dev),
            torch.as_tensor(np.asarray(attention_mask, dtype=np.int64), device=dev),
            generator,
        )
        return out.cpu().numpy()


def _device_of(tree: Any) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device
