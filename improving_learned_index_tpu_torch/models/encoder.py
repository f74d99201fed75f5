"""Transformer encoder trunk + impact head (PyTorch ``nn.Module``s).

Counterpart of ``improving_learned_index_tpu/models/encoder.py``: a
BERT/RoBERTa/XLM-R geometry trunk whose last hidden state feeds a
``Linear(hidden, 1)`` impact head with ReLU (DeepImpact) or Softplus (XLM-R
variant) (reference original.py:41-94, xlmr_original.py:31-85).

Precision is the JAX package's, written as explicit casts (no autocast):

- parameters are fp32; every projection casts its input and weight to the
  compute dtype (``config.dtype``), so the product comes out in that dtype,
  and then adds the bias cast to the same dtype -- two roundings, as the
  flax einsum-then-add has;
- the embedding sum and its LayerNorm run in fp32, then cast; both
  LayerNorms of a layer run in fp32 on ``(x + residual)`` summed in the
  compute dtype; GELU is exact (erf);
- the last hidden state is cast to fp32 and the impact head is an fp32
  Linear.

Attention takes one of three routes, as in the JAX package.  With a mask,
``use_short_attention``, S <= 256, S % 128 == 0 and head dim % 8 == 0 it
calls ``ops.short_attention`` (the hand-written kernel on the card, its
plain version on the CPU or with ``use_kernels=False``, with -1e9 masking
and ``* sm_scale``; both forwards share the JAX ``custom_vjp``'s backward,
a recompute through the XLA route's bf16 math).  Where that route does not
apply, ``use_flash_attention`` is set and S % 128 == 0 (the JAX package's
library flash route, ``models/encoder.py:112-125``), it calls
``ops.flash_attention`` non-causal with the mask (padding mask, or packed
segment ids) as segment ids: the hand-written kernel on the card (head dim
64 or 128), the twin on the CPU or with ``use_kernels=False``, its backward
the library's; padding queries attend the padding keys there, so only the
real tokens' outputs equal the other routes'.  Otherwise
it runs the JAX package's XLA-path math in plain torch ops: logits in the
compute dtype cast to fp32, ``/ sqrt(hd)``, ``finfo(fp32).min`` masking, an
fp32 softmax cast back.  That route is not a Pallas kernel in the JAX
package either.

``output_attentions=True`` takes the plain route at every S, as the JAX
package turns its kernels off when the maps are asked for, and returns each
layer's probabilities as JAX does (fp32 softmax, cast to the compute dtype,
back to fp32), already averaged over heads: [B, S, S] a layer, the one form
``models.pairwise`` reads, never [L, B, heads, S, S].

Parameter layout is torch's: ``Linear`` weights are [out, in]
(``models.hf_import`` carries the flax [in, out] / [H, heads, hd] /
[heads, hd, H] kernels across).  The same modules encode and train
(``train/trainer.py`` differentiates them as the JAX loss differentiates
the flax module with ``deterministic=True``): no dropout.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import EncoderConfig
from ..ops.flash_attention import flash_attention
from ..ops.short_attention import can_use_short_attention, short_attention


def compute_dtype(config: EncoderConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config.dtype]


def make_position_ids(input_ids: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """BERT: arange.  RoBERTa-family (position_offset > 0): positions count
    only non-pad tokens and are offset past the pad id, matching HF
    ``create_position_ids_from_input_ids``."""
    bsz, seq = input_ids.shape
    if config.position_offset == 0:
        return torch.arange(seq, device=input_ids.device).expand(bsz, seq)
    mask = (input_ids != config.pad_token_id).long()
    return torch.cumsum(mask, dim=1) * mask + config.pad_token_id


def make_packed_position_ids(segment_ids: torch.Tensor, config: EncoderConfig) -> torch.Tensor:
    """Position ids for sequence-packed rows: positions restart at every
    segment boundary (a running max of boundary columns, the JAX
    ``associative_scan(max)``).  BERT: 0..L-1 within the segment.
    RoBERTa-family: pad_id + 1 + within-segment index on real tokens, pad_id
    on padding."""
    bsz, seq = segment_ids.shape
    idx = torch.arange(seq, device=segment_ids.device).expand(bsz, seq)
    boundary = torch.ones_like(segment_ids, dtype=torch.bool)
    boundary[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    start = torch.cummax(torch.where(boundary, idx, 0), dim=1).values
    within = idx - start
    if config.position_offset == 0:
        return within
    return torch.where(segment_ids > 0, within + 1 + config.pad_token_id, config.pad_token_id)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: product in ``dtype``, then the bias in
    ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


class Embeddings(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        c = config
        self.config = c
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, input_ids, type_ids, position_ids=None):
        if position_ids is None:
            position_ids = make_position_ids(input_ids, self.config)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(position_ids)
            + self.token_type_embeddings(type_ids)
        )
        return self.layer_norm(x).to(compute_dtype(self.config))


class SelfAttention(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        h = config.hidden_size
        self.config = config
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.output_dense = nn.Linear(h, h)

    def forward(self, x, attention_bias, attention_mask, packed=False, use_kernels=True, flash=False):
        """``attention_bias`` None selects a kernel route (mask as int32
        padding mask or segment ids): ``flash_attention`` with ``flash``,
        else ``short_attention``; otherwise the additive fp32 bias of the
        plain route.  Returns (output, probabilities), the probabilities
        [B, heads, S, S] in the compute dtype on the plain route and None on
        the kernels'."""
        c = self.config
        b, s, hid = x.shape
        heads = c.num_heads
        hd = hid // heads
        dt = compute_dtype(c)
        # [B, S, heads, hd] memory; the kernel reads it as [B, heads, S, hd]
        q, k, v = (
            _linear(x, lin, dt).view(b, s, heads, hd).permute(0, 2, 1, 3)
            for lin in (self.query, self.key, self.value)
        )
        probs = None
        if attention_bias is None and flash:
            ctx = flash_attention(q, k, v, attention_mask, attention_mask, causal=False,
                                  sm_scale=1.0 / math.sqrt(hd), use_kernel=use_kernels)
        elif attention_bias is None:  # the short-attention route
            ctx = short_attention(q, k, v, attention_mask, 1.0 / math.sqrt(hd), packed,
                                  use_kernel=use_kernels)
        else:
            logits = torch.matmul(q, k.transpose(-1, -2)).float()
            logits = logits / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
            probs = torch.softmax(logits + attention_bias, dim=-1).to(dt)
            ctx = torch.matmul(probs, v)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, hid)
        return _linear(ctx, self.output_dense, dt), probs


class EncoderLayer(nn.Module):
    def __init__(self, config: EncoderConfig):
        super().__init__()
        c = config
        self.config = c
        self.attention = SelfAttention(c)
        self.attention_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.output_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, x, attention_bias, attention_mask, packed=False, use_kernels=True, flash=False):
        """Returns (hidden, the attention's probabilities or None)."""
        dt = compute_dtype(self.config)
        attn, probs = self.attention(x, attention_bias, attention_mask, packed, use_kernels, flash)
        x = self.attention_norm((x + attn).float()).to(dt)
        h = F.gelu(_linear(x, self.intermediate, dt), approximate="none")
        h = _linear(h, self.output, dt)
        return self.output_norm((x + h).float()).to(dt), probs


class TransformerEncoder(nn.Module):
    """BERT-family trunk returning the last hidden state [B, L, H] (fp32);
    with ``output_attentions`` also each layer's head-mean attention map
    [B, L, L] (fp32), in layer order."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config)
        self.layers = nn.ModuleList(EncoderLayer(config) for _ in range(config.num_layers))

    def forward(self, input_ids, attention_mask, type_ids=None, segment_ids=None, use_kernels=True,
                output_attentions=False):
        c = self.config
        if type_ids is None:
            type_ids = torch.zeros_like(input_ids)
        packed = segment_ids is not None
        if packed:
            # sequence-packed batch: block-diagonal attention within each
            # packed document, positions restart per segment; the kernel gets
            # the raw segment ids, the additive bias encodes segment equality
            x = self.embeddings(
                input_ids, type_ids, make_packed_position_ids(segment_ids, c)
            )
            kernel_mask = segment_ids
        else:
            x = self.embeddings(input_ids, type_ids)
            kernel_mask = attention_mask
        bias = None
        seq = input_ids.shape[1]
        short = c.use_short_attention and can_use_short_attention(seq, c.hidden_size // c.num_heads)
        flash = not short and c.use_flash_attention and seq % 128 == 0
        if output_attentions or not (short or flash):
            if packed:
                allowed = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
            else:
                allowed = attention_mask[:, None, None, :].bool()
            bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min).to(torch.float32)
        kernel_mask = kernel_mask.to(torch.int32)
        maps = []
        for layer in self.layers:
            x, probs = layer(x, bias, kernel_mask, packed, use_kernels, flash and bias is None)
            if output_attentions:
                maps.append(probs.float().mean(dim=1))
        if output_attentions:
            return x.float(), maps
        return x.float()


class ImpactHead(nn.Module):
    """Linear(hidden, 1) + ReLU | Softplus: one scalar impact per token
    (reference original.py:44-47, xlmr_original.py:34-38)."""

    def __init__(self, hidden_size: int, activation: str = "relu"):
        super().__init__()
        if activation not in ("relu", "softplus"):
            raise ValueError(f"unknown impact activation {activation}")
        self.activation = activation
        self.dense = nn.Linear(hidden_size, 1)

    def forward(self, hidden_states):
        score = self.dense(hidden_states.float())
        return F.relu(score) if self.activation == "relu" else F.softplus(score)


class DeepImpactModel(nn.Module):
    """Trunk + per-token impact head -> [B, L, 1] impact scores."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.encoder = TransformerEncoder(config)
        self.impact_head = ImpactHead(config.hidden_size, config.impact_activation)

    def forward(
        self,
        input_ids,
        attention_mask,
        type_ids=None,
        segment_ids: Optional[torch.Tensor] = None,
        use_kernels: bool = True,
    ):
        hidden = self.encoder(input_ids, attention_mask, type_ids, segment_ids, use_kernels)
        return self.impact_head(hidden)


class CrossEncoderModel(nn.Module):
    """Trunk + impact head on the [CLS] hidden state -> [B, 1] relevance
    score (reference models/cross_encoder.py:9-37).  Its parameter names are
    ``DeepImpactModel``'s, so a DeepImpact state dict loads into it."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.encoder = TransformerEncoder(config)
        self.impact_head = ImpactHead(config.hidden_size, config.impact_activation)

    def forward(self, input_ids, attention_mask, type_ids=None, use_kernels: bool = True):
        hidden = self.encoder(input_ids, attention_mask, type_ids, use_kernels=use_kernels)
        return self.impact_head(hidden[:, 0, :])


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with flax's initializer shapes and scales (not its
    numbers): embeddings N(0, 1/hidden); Linear weights lecun-normal
    (truncated at 2 sigma, std 1/sqrt(fan_in)); biases 0; LayerNorm 1, 0."""
    for m in model.modules():
        if isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, m.embedding_dim ** -0.5, generator=generator)
        elif isinstance(m, nn.Linear):
            std = m.in_features ** -0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
