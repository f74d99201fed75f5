"""T5/mT5 doc2query generation.

Counterpart of ``improving_learned_index_tpu/expand/t5_generate.py`` (the
reference T5QueryGenerator, src/llama2/generate.py:82-101, generate_t5.py:
documents in, N sampled queries out, no prompt template: T5 reads the
document itself).  The encoder runs once per batch (on every repeated row
of ``num_return_sequences``, as the JAX sampler runs it), the cross K/V are
computed once from its output, then the decoder runs one Python step a
token on the tree's device with a self-attention cache of ``max_new_tokens +
1`` slots: step 0 feeds ``decoder_start_token_id``, step t the token of step
t-1.  The masked self-attention position bias of every step is built once
(buckets on the host) and step t reads its row.  The output buffer starts
filled with EOS; a row that has finished is forced to EOS; the loop stops
when every row has finished.  A quantized tree is dequantized in fp32 at
each use, one sub-module at a time (the JAX T5 sampler's
``dequantize_params(..., float32)``).

Sampling draws Gumbel-max from an explicit ``torch.Generator`` seeded per
call (``expand.sampling.sample_token``): the distribution of
``jax.random.categorical``, not its tokens.  Greedy decoding gives the JAX
package's tokens.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List

import numpy as np
import torch

from ..core.config import GenerationConfig
from ..core.device import resolve_device
from ..models.llama import tree_to
from ..models.t5 import T5Config, T5Model, make_t5_kv_caches
from .sampling import _device_of, sample_token


class T5Sampler:
    """Encoder once, then step-by-step decode for a ``T5Model`` over a
    parameter tree (full precision or quantized) on the tree's device."""

    def __init__(self, config: T5Config, gen: GenerationConfig, decoder_start_token_id: int = 0,
                 eos_token_id: int = 1):
        self.config = config
        self.gen = gen
        self.start_id = decoder_start_token_id
        self.eos = eos_token_id
        self.module = T5Model(config, device="meta")

    @torch.no_grad()
    def run(self, params: Dict[str, Any], enc_ids: torch.Tensor, enc_mask: torch.Tensor,
            generator: torch.Generator) -> torch.Tensor:
        """[B, max_new_tokens] int32 ids on the params' device, EOS wherever
        no token was drawn."""
        module, eos, max_new = self.module, self.eos, self.gen.max_new_tokens
        dev = enc_ids.device
        bsz = enc_ids.shape[0]
        enc_out = module.encode(enc_ids, enc_mask, params=params)
        cross_kvs = module.compute_cross_kvs(enc_out, params=params)
        caches = make_t5_kv_caches(self.config, bsz, max_new + 1, device=dev)
        # every step's masked position bias, once: step t reads row t
        self_bias = module.decoder_self_bias(0, max_new, max_new + 1, params, dev)
        out = torch.full((bsz, max_new), eos, dtype=torch.int32, device=dev)
        cur = torch.full((bsz,), self.start_id, dtype=torch.int32, device=dev)
        finished = torch.zeros(bsz, dtype=torch.bool, device=dev)
        t = 0
        while t < max_new and not bool(finished.all()):
            logits, caches = module.decode(cur[:, None], enc_out, enc_mask, kv_caches=caches, cache_index=t,
                                           cross_kvs=cross_kvs, params=params, self_bias=self_bias[:, :, t:t + 1])
            nxt = sample_token(logits[:, 0, :], self.gen, generator).to(torch.int32)
            nxt = torch.where(finished, eos, nxt)
            out[:, t] = nxt
            finished = finished | (nxt == eos)
            cur = nxt
            t += 1
        return out

    def generate(self, params: Dict[str, Any], enc_ids: np.ndarray, enc_mask: np.ndarray,
                 num_return_sequences: int = 1, seed: int = 0) -> np.ndarray:
        """[B * num_return_sequences, max_new_tokens] ids (see ``run``); rows
        i*k..(i+1)*k are the k samples for document i."""
        if num_return_sequences > 1:
            enc_ids = np.repeat(enc_ids, num_return_sequences, axis=0)
            enc_mask = np.repeat(enc_mask, num_return_sequences, axis=0)
        dev = _device_of(params)
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed)
        out = self.run(params, torch.as_tensor(np.asarray(enc_ids, dtype=np.int64), device=dev),
                       torch.as_tensor(np.asarray(enc_mask, dtype=np.int64), device=dev), generator)
        return out.cpu().numpy()


class T5QueryGenerator:
    """Documents -> N sampled queries each (the reference T5 contract).
    ``params`` (a full precision or quantized tree) is moved to ``device``
    once; ``device`` defaults to ``cuda`` and raises without one."""

    def __init__(
        self,
        params,
        config: T5Config,
        tokenizer,  # encode(text)->ids (EOS as the tokenizer adds it), decode(ids)->str
        gen: GenerationConfig = GenerationConfig(),
        pad_token_id: int = 0,
        eos_token_id: int = 1,
        decoder_start_token_id: int = 0,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.config = config
        self.tokenizer = tokenizer
        self.gen = gen
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.sampler = T5Sampler(config, gen, decoder_start_token_id=decoder_start_token_id,
                                 eos_token_id=eos_token_id)

    def tokenize(self, documents: List[str]):
        """Right-padded encoder batch, each document cut to ``max_tokens``."""
        encoded = [self.tokenizer.encode(d)[: self.gen.max_tokens] for d in documents]
        max_len = max(len(e) for e in encoded)
        ids = np.full((len(encoded), max_len), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(encoded), max_len), dtype=np.int32)
        for i, e in enumerate(encoded):
            ids[i, : len(e)] = e
            mask[i, : len(e)] = 1
        return ids, mask

    def generate(self, documents: List[str], seed: int = 0) -> List[List[str]]:
        """num_return_sequences decoded queries per document: every EOS token
        dropped, the rest decoded, whitespace runs collapsed."""
        ids, mask = self.tokenize(documents)
        out = self.sampler.generate(self.params, ids, mask, num_return_sequences=self.gen.num_return_sequences,
                                    seed=seed)
        n = self.gen.num_return_sequences
        queries: List[List[str]] = []
        for i in range(len(documents)):
            decoded = []
            for j in range(n):
                toks = out[i * n + j]
                toks = toks[toks != self.eos_token_id]
                text = self.tokenizer.decode([int(t) for t in toks])
                decoded.append(re.sub(r"\s{2,}", " ", text).strip())
            queries.append(decoded)
        return queries
