"""doc2query fine-tuning: LoRA adapters on the Llama decoder.

Counterpart of ``improving_learned_index_tpu/expand/finetune.py`` (the
reference FineTuner, src/llama2/finetune/finetune.py:41-216): (document,
query) pairs become ``prompt(document) + query + eos`` with the prompt's
labels ignored (-100), only the adapters train (AdamW with the JAX
default weight decay 1e-4, optionally after a global-norm clip done as
optax does), the frozen base full precision or quantized (int8 / packed
int4, the reference's NF4 QLoRA base) and dequantized inside the step.

Two schedules of the same loss:

- merged: the whole base dequantized, the adapters merged, one forward of
  ``LlamaModel`` on the merged tree, full ``[B, S, vocab]`` logits and
  ``causal_lm_loss``;
- layerwise (``layerwise=None`` turns it on for a quantized base of >= 16
  layers): each layer's weights dequantized and merged inside a
  ``torch.utils.checkpoint`` region (the backward recomputes them, so about
  one layer's full-precision weights are live at a time), and the CE over
  256-position chunks of the head, each in its own checkpoint region, so
  the fp32 logits of all positions are never live together.

With ``config.use_flash_attention`` each layer's attention is
``ops.flash_attention`` (causal, the attention mask as segment ids): the
hand-written forward and backward kernels on the card, the twin on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device, resolve_use_kernels
from ..core.logging import get_logger
from ..models.llama import (
    LlamaConfig,
    LlamaModel,
    _flat,
    attention_bias,
    compute_dtype,
    llama_port_params_to_flax,
    tree_map,
    tree_to,
)
from ..models.quantization import dequantize_params, quantize_params_int4, quantize_params_int8
from .generate import PROMPT_EN
from .lora import LoraConfig, init_lora_params, lora_forward_params, lora_leaves, merge_lora

logger = get_logger("finetune")

IGNORE_INDEX = -100


def build_example(
    tokenizer,
    document: str,
    query: str,
    prompt_template: str = PROMPT_EN,
    max_length: int = 2048,
    eos_token_id: int = 2,
    bos_token_id: int = 1,
) -> Tuple[List[int], List[int]]:
    """(input_ids, labels) with prompt positions labeled IGNORE_INDEX; the
    query's own leading BOS is dropped when both start with ``bos_token_id``."""
    prompt_ids = tokenizer.encode(prompt_template.format(doc=document))
    query_ids = tokenizer.encode(query)
    if query_ids and prompt_ids and query_ids[0] == prompt_ids[0] == bos_token_id:
        query_ids = query_ids[1:]
    ids = (prompt_ids + query_ids + [eos_token_id])[:max_length]
    labels = ([IGNORE_INDEX] * len(prompt_ids) + query_ids + [eos_token_id])[:max_length]
    return ids, labels


def collate_examples(examples: List[Tuple[List[int], List[int]]], pad_token_id: int = 0) -> Dict[str, np.ndarray]:
    """Right-padded int32 ``input_ids``, ``labels`` (-100 on padding) and
    ``attention_mask``."""
    max_len = max(len(ids) for ids, _ in examples)
    n = len(examples)
    input_ids = np.full((n, max_len), pad_token_id, dtype=np.int32)
    labels = np.full((n, max_len), IGNORE_INDEX, dtype=np.int32)
    mask = np.zeros((n, max_len), dtype=np.int32)
    for i, (ids, labs) in enumerate(examples):
        input_ids[i, : len(ids)] = ids
        labels[i, : len(labs)] = labs
        mask[i, : len(ids)] = 1
    return {"input_ids": input_ids, "labels": labels, "attention_mask": mask}


def _deq_merge(subtree, lora_subtree, lora_config, dt):
    merged = dequantize_params(subtree, dt)
    return merge_lora(merged, lora_subtree, lora_config) if lora_subtree else merged


def _layerwise_trunk(config: LlamaConfig, lora_config: LoraConfig, lora, base_params, batch,
                     module: LlamaModel, use_kernels: bool = True):
    """Hidden states after the final norm and the (merged) ``[hidden, vocab]``
    head kernel (the tied embedding transposed with ``tie_word_embeddings``);
    each layer dequantized and merged inside its checkpoint region."""
    c = config
    dt = compute_dtype(c)
    input_ids, attention_mask = batch["input_ids"], batch["attention_mask"]
    bsz, qlen = input_ids.shape
    embed = _deq_merge(base_params["embed_tokens"], lora.get("embed_tokens"), lora_config, dt)
    x = embed["embedding"][input_ids].to(dt)
    positions = torch.arange(qlen, device=input_ids.device)[None].expand(bsz, qlen)
    bias = attention_bias(attention_mask, qlen)
    seg_ids = attention_mask if c.use_flash_attention else None

    def layer_step(x, layer, layer_q, layer_lora):
        merged = _deq_merge(layer_q, layer_lora, lora_config, dt)
        out, _ = functional_call(layer, _flat(merged), (x, positions, bias, None, None, seg_ids, use_kernels))
        return out

    for i in range(c.num_layers):
        key = f"layer_{i}"
        x = checkpoint(layer_step, x, getattr(module, key), base_params[key], lora.get(key, {}),
                       use_reentrant=False)
    norm = dequantize_params(base_params["norm"], dt)
    x = functional_call(module.norm, _flat(norm), (x,))
    if c.tie_word_embeddings:
        head_kernel = embed["embedding"].t()
    else:
        head_kernel = _deq_merge(base_params["lm_head"], lora.get("lm_head"), lora_config, dt)["kernel"]
    return x, head_kernel


def layerwise_lm_logits(config, lora_config, lora, base_params, batch, module, use_kernels=True):
    """Full ``[B, S, vocab]`` fp32 logits through the layerwise trunk."""
    x, head = _layerwise_trunk(config, lora_config, lora, base_params, batch, module, use_kernels)
    return torch.matmul(x.to(torch.float32), head.to(torch.float32))


def _chunk_ce(xc, labc, head):
    logits = torch.matmul(xc.to(torch.float32), head.to(torch.float32))
    valid = labc != IGNORE_INDEX
    safe = torch.where(valid, labc, 0)
    logz = torch.logsumexp(logits, dim=-1)
    tok = logz - torch.gather(logits, -1, safe[..., None])[..., 0]
    return torch.where(valid, tok, 0.0).sum(), valid.sum()


def layerwise_lm_loss(config, lora_config, lora, base_params, batch, module, use_kernels=True,
                      chunk: int = 256) -> torch.Tensor:
    """Next-token CE through the layerwise trunk with the head computed
    ``chunk`` positions at a time, each chunk in a checkpoint region."""
    x, head = _layerwise_trunk(config, lora_config, lora, base_params, batch, module, use_kernels)
    labels = batch["labels"]
    bsz, qlen, _ = x.shape
    shifted = torch.cat([labels[:, 1:], torch.full((bsz, 1), IGNORE_INDEX, dtype=labels.dtype,
                                                   device=labels.device)], dim=1)
    chunk = min(chunk, qlen)
    loss_sum = torch.zeros((), device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for start in range(0, qlen, chunk):
        s, n = checkpoint(_chunk_ce, x[:, start:start + chunk], shifted[:, start:start + chunk], head,
                          use_reentrant=False)
        loss_sum = loss_sum + s
        count = count + n
    return loss_sum / torch.clamp(count, min=1)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token CE averaged over non-ignored positions (HF semantics)."""
    shift_logits = logits[:, :-1, :]
    shift_labels = labels[:, 1:]
    valid = shift_labels != IGNORE_INDEX
    safe = torch.where(valid, shift_labels, 0)
    log_probs = torch.log_softmax(shift_logits, dim=-1)
    tok = -torch.gather(log_probs, -1, safe[..., None].long())[..., 0]
    return torch.where(valid, tok, 0.0).sum() / torch.clamp(valid.sum(), min=1)


class Doc2QueryFineTuner:
    """LoRA fine-tuning loop over (document, query) pairs.

    ``quantize_base``: ``None`` keeps the frozen base as given; ``"int8"`` /
    ``"int4"`` quantize it on ``device`` (default ``cuda``; raises without
    one).  Adapters are fp32 and the only parameters.  ``use_kernels=False``
    on the card runs the flash twin, for cross-checks only.
    """

    def __init__(
        self,
        params,
        config: LlamaConfig,
        tokenizer,
        lora_config: LoraConfig = LoraConfig(r=16, alpha=32),
        lr: float = 2e-4,
        prompt_template: str = PROMPT_EN,
        max_length: int = 2048,
        eos_token_id: int = 2,
        pad_token_id: int = 0,
        bos_token_id: int = 1,
        seed: int = 0,
        quantize_base_int8: bool = False,
        quantize_base: Optional[str] = None,
        max_grad_norm: Optional[float] = None,
        weight_decay: float = 1e-4,  # optax.adamw's default, not torch's 1e-2
        layerwise: Optional[bool] = None,
        device=None,
        use_kernels: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        self.use_kernels = resolve_use_kernels(self.device, use_kernels)
        self.config = config
        self.tokenizer = tokenizer
        self.lora_config = lora_config
        self.prompt_template = prompt_template
        self.max_length = max_length
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id
        self.bos_token_id = bos_token_id
        self.module = LlamaModel(config, device="meta")
        self.lora = init_lora_params(params, lora_config, seed, self.device)
        leaves = lora_leaves(self.lora)
        if not leaves:
            # a pre-quantized tree has {"q","s"} dicts under each kernel, so
            # the target scan finds nothing: training would be a no-op
            raise ValueError(
                "no LoRA targets found in params — pass full-precision params "
                "(quantize via quantize_base=...), and check lora_config.targets"
            )
        for t in leaves:
            t.requires_grad_(True)
        if quantize_base_int8 and quantize_base is None:
            quantize_base = "int8"
        quantizers = {"int8": quantize_params_int8, "int4": quantize_params_int4}
        if quantize_base is not None and quantize_base not in quantizers:
            raise ValueError(f"quantize_base must be int8/int4/None, got {quantize_base!r}")
        base = tree_to(params, self.device)
        self.base_params = quantizers[quantize_base](base) if quantize_base else base
        self.quantize_base = quantize_base
        self.max_grad_norm = max_grad_norm
        self.optimizer = torch.optim.AdamW(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=weight_decay)
        if layerwise is None:
            layerwise = quantize_base is not None and config.num_layers >= 16
        self.layerwise = layerwise

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.layerwise:
            return layerwise_lm_loss(self.config, self.lora_config, self.lora, self.base_params, batch,
                                     self.module, self.use_kernels)
        base = dequantize_params(self.base_params, compute_dtype(self.config))
        merged = lora_forward_params(base, self.lora, self.lora_config)
        logits, _ = self.module(batch["input_ids"], batch["attention_mask"], params=merged,
                                use_kernels=self.use_kernels)
        return causal_lm_loss(logits, batch["labels"])

    def _to_device(self, arrays: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v.astype(np.int64), device=self.device) for k, v in arrays.items()}

    def train_step(self, arrays: Dict[str, np.ndarray]) -> torch.Tensor:
        """One AdamW step on one collated batch; returns the loss (on the
        device)."""
        from ..train.trainer import clip_by_global_norm_

        leaves = lora_leaves(self.lora)
        loss = self.loss(self._to_device(arrays))
        grads = list(torch.autograd.grad(loss, leaves))
        if self.max_grad_norm is not None:
            clip_by_global_norm_(grads, self.max_grad_norm)
        for p, g in zip(leaves, grads):
            p.grad = g
        self.optimizer.step()
        return loss.detach()

    def make_batch(self, pairs: List[Tuple[str, str]]) -> Dict[str, np.ndarray]:
        """Collated examples; on the flash route the length is padded up to a
        multiple of 128, the kernel's tile (padding is ignored by the loss and,
        as segment 0, attended only by padding, so the loss is unchanged)."""
        examples = [
            build_example(self.tokenizer, doc, query, self.prompt_template, self.max_length,
                          self.eos_token_id, self.bos_token_id)
            for doc, query in pairs
        ]
        batch = collate_examples(examples, self.pad_token_id)
        pad = -batch["input_ids"].shape[1] % 128 if self.config.use_flash_attention else 0
        if pad:
            fill = {"input_ids": self.pad_token_id, "labels": IGNORE_INDEX, "attention_mask": 0}
            batch = {k: np.pad(v, ((0, 0), (0, pad)), constant_values=fill[k]) for k, v in batch.items()}
        return batch

    def train(
        self,
        pairs: Iterable[Tuple[str, str]],
        batch_size: int = 4,
        total_steps: Optional[int] = None,
        log_every: int = 10,
    ) -> float:
        total_loss, step = 0.0, 0
        batch: List[Tuple[str, str]] = []
        stop = False
        for pair in pairs:
            batch.append(pair)
            if len(batch) < batch_size:
                continue
            arrays = self.make_batch(batch)
            batch = []
            loss = float(self.train_step(arrays))
            total_loss += loss
            step += 1
            if step % log_every == 0:
                logger.info(f"finetune step {step} loss {loss:.4f}")
            if total_steps is not None and step >= total_steps:
                stop = True
                break
        if batch and not stop:
            # a trailing partial batch still trains
            total_loss += float(self.train_step(self.make_batch(batch)))
            step += 1
        return total_loss / max(step, 1)

    @torch.no_grad()
    def merged_params(self):
        """Base weights with the adapters folded in, fp32 (a quantized base
        dequantized to fp32 first, as peft's merge_and_unload on 4 bits)."""
        base = dequantize_params(self.base_params, torch.float32)
        return tree_map(lambda t: t.detach(), merge_lora(base, self.lora, self.lora_config))

    def save_adapter(self, path) -> None:
        """The adapters as a flax msgpack (the JAX ``save_params`` bytes)."""
        from ..core.flax_msgpack import write

        write(path, llama_port_params_to_flax(tree_map(lambda t: t.detach(), self.lora)))

    @classmethod
    def trl_4bit(cls, params, config: LlamaConfig, tokenizer, **overrides):
        """The reference's ``finetune_4bit.py`` (TRL SFTTrainer) recipe: int4
        base, LoRA r=64 alpha=16, lr 2e-4, clip 0.3, weight decay 0.001."""
        kwargs = dict(
            lora_config=LoraConfig(r=64, alpha=16),
            lr=2e-4,
            quantize_base="int4",
            max_grad_norm=0.3,
            weight_decay=0.001,
        )
        kwargs.update(overrides)
        return cls(params, config, tokenizer, **kwargs)


def load_adapter(path) -> Dict[str, Any]:
    """A saved adapter tree (this module's or the JAX package's msgpack) as
    CPU fp32 tensors."""
    from ..core.flax_msgpack import read

    return tree_map(lambda a: torch.from_numpy(np.array(a, order="C")), read(path))
