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

A layer's passes between its matrix products (the six bias adds, the two
residual adds and LayerNorms, the GELU) run in hand-written kernels where
``epilogue_route`` says so: where the kernels launch
(``ops._kernels.launches``: CUDA, outside ``ops.plain_versions()``), no
autograd (``inference_mode`` or ``no_grad``), bf16 compute and widths the
kernels take.  Three launches a layer go to ``ops.encoder_epilogue``
(``csrc/encoder_epilogue.cu``: the q, k and v biases, and bias + residual +
LayerNorm twice); the FFN's first product, its bias and its GELU are one
launch of ``ops.linear_gelu`` (``csrc/linear_gelu.cu``) where it takes the
widths (``linear_gelu.takes``), else that product and
``encoder_epilogue``'s bias + GELU.  The rounding points above do not move
there: the other products stay bias-free and the kernels add the bias to
the rounded product, rounding once more, as ``linear_gelu`` does inside its
product; only the order of the fp32 sums (the LayerNorm's, the FFN
product's over K) differs.  Elsewhere (training, the CPU, fp32) the same passes run as the
PyTorch ops above, each bias added as its product comes, so a forward
under autograd holds what it held before the kernels; the kernels' plain
versions (``encoder_epilogue.*_plain``) compute the same values.

Attention takes one of three routes, chosen from the shape in
``attention_route``.  With a mask, ``use_short_attention``, S <= 256,
S % 128 == 0 and head dim % 8 == 0 it calls ``ops.short_attention`` (the
hand-written kernel on the card, its plain version on the CPU or inside
``ops.plain_versions()``, with -1e9 masking and ``* sm_scale``; both
forwards share the JAX ``custom_vjp``'s backward, a recompute through the
XLA route's bf16 math).  Where that route does not apply, S % 128 == 0 and
``use_flash_attention`` is set (the default), it calls
``ops.flash_attention`` non-causal with the mask (padding mask, or packed
segment ids) as segment ids: the hand-written kernel on the card where the
head dim is 64 or 128, the twin on the CPU or inside
``ops.plain_versions()``, its backward the library's; padding queries
attend the padding keys there, so only the real tokens' outputs equal the
other routes'.  So an encoder at S=512 (XLM-R's ``max_length``) reaches
``csrc/flash_attention.cu`` on the card.  Otherwise it runs the JAX
package's XLA-path math in plain torch ops: logits in the compute dtype
cast to fp32, ``/ sqrt(hd)``, ``finfo(fp32).min`` masking, an fp32 softmax
cast back.  That route is not a Pallas kernel in the JAX package either.  ``TransformerEncoder`` decides
the route and ``epilogue_route`` once a forward and hands both to every
layer.  Each forward is one ``core.profiling.annotate`` region named by its
route: ``encoder/route_short``, ``encoder/route_flash`` or
``encoder/route_plain``.

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
from ..core.profiling import annotate
from ..ops import encoder_epilogue, linear_gelu
from ..ops._kernels import launches
from ..ops.flash_attention import KERNEL_DIMS, flash_attention
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


def attention_route(config: EncoderConfig, seq: int, device: torch.device, output_attentions: bool = False) -> str:
    """``short``, ``flash`` or ``plain``: the attention route of a forward at
    sequence length ``seq`` on ``device`` (see the module docstring).  Where
    the flash kernel launches (``launches``) it takes head dim 64 or 128
    only; elsewhere the twin takes any."""
    hd = config.hidden_size // config.num_heads
    if output_attentions:
        return "plain"
    if config.use_short_attention and can_use_short_attention(seq, hd):
        return "short"
    if config.use_flash_attention and seq % 128 == 0 and (hd in KERNEL_DIMS or not launches(device)):
        return "flash"
    return "plain"


def epilogue_route(device: torch.device, grad_enabled: bool, dtype: torch.dtype, hidden: int,
                   intermediate: int) -> bool:
    """True where a layer's bias, residual, LayerNorm and GELU passes run in
    ``csrc/encoder_epilogue.cu`` (see the module docstring): the kernels
    launch on ``device`` (``launches``), grad off, bf16 compute and widths
    the kernels take.  The kernels have no backward."""
    return (launches(device) and not grad_enabled and dtype == torch.bfloat16
            and encoder_epilogue.takes(hidden, intermediate))


def _product(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``'s product in ``dtype``, before its bias."""
    return F.linear(x.to(dtype), layer.weight.to(dtype))


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=dtype)``: product in ``dtype``, then the bias in
    ``dtype``; the product is freed before the next op."""
    return encoder_epilogue.bias_add_plain(_product(x, layer, dtype), layer.bias)


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

    def forward(self, x, attention_bias, attention_mask, packed, route, fused):
        """``route`` (``attention_route``): ``flash`` and ``short`` call
        ``flash_attention`` and ``short_attention`` with the int32 mask
        (padding mask or segment ids); ``plain`` adds the fp32
        ``attention_bias``.  ``fused`` (``epilogue_route``): q, k and v take
        their biases in ``encoder_epilogue``'s kernel, and the output
        projection is returned before its bias, which the layer's kernel
        adds with the residual.  Returns (output, probabilities), the
        probabilities [B, heads, S, S] in the compute dtype on the plain
        route and None on the others."""
        c = self.config
        b, s, hid = x.shape
        heads = c.num_heads
        hd = hid // heads
        dt = compute_dtype(c)
        lins = (self.query, self.key, self.value)
        if fused:  # the three products, then their biases in one launch
            qkv = encoder_epilogue.bias_add(*(_product(x, lin, dt) for lin in lins), *(lin.bias for lin in lins))
        else:  # each product and its bias in turn
            qkv = (_linear(x, lin, dt) for lin in lins)
        # [B, S, heads, hd] memory; the kernel reads it as [B, heads, S, hd]
        q, k, v = (t.view(b, s, heads, hd).permute(0, 2, 1, 3) for t in qkv)
        probs = None
        if route == "flash":
            ctx = flash_attention(q, k, v, attention_mask, attention_mask, causal=False,
                                  sm_scale=1.0 / math.sqrt(hd))
        elif route == "short":
            ctx = short_attention(q, k, v, attention_mask, 1.0 / math.sqrt(hd), packed)
        else:
            logits = torch.matmul(q, k.transpose(-1, -2)).float()
            logits = logits / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32))
            probs = torch.softmax(logits + attention_bias, dim=-1).to(dt)
            ctx = torch.matmul(probs, v)
        ctx = ctx.permute(0, 2, 1, 3).reshape(b, s, hid)
        return (_product if fused else _linear)(ctx, self.output_dense, dt), probs


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

    def forward(self, x, attention_bias, attention_mask, packed, route, fused):
        """Returns (hidden, the attention's probabilities or None); ``route``
        and ``fused`` as ``SelfAttention.forward`` takes them."""
        dt = compute_dtype(self.config)
        attn, probs = self.attention(x, attention_bias, attention_mask, packed, route, fused)
        if not fused:  # the PyTorch ops, each bias added as its product comes
            x = self.attention_norm((x + attn).float()).to(dt)
            h = F.gelu(_linear(x, self.intermediate, dt), approximate="none")
            h = _linear(h, self.output, dt)
            return self.output_norm((x + h).float()).to(dt), probs
        an, on = self.attention_norm, self.output_norm
        x = encoder_epilogue.bias_residual_layernorm(attn, self.attention.output_dense.bias, x, an.weight, an.bias,
                                                     an.eps)
        if linear_gelu.takes(self.config.hidden_size, self.config.intermediate_size):
            h = linear_gelu.linear_gelu(x, self.intermediate.weight.to(dt), self.intermediate.bias)
        else:
            h = encoder_epilogue.bias_gelu(_product(x, self.intermediate, dt), self.intermediate.bias)
        return encoder_epilogue.bias_residual_layernorm(_product(h, self.output, dt), self.output.bias, x, on.weight,
                                                        on.bias, on.eps), probs


class TransformerEncoder(nn.Module):
    """BERT-family trunk returning the last hidden state [B, L, H] (fp32);
    with ``output_attentions`` also each layer's head-mean attention map
    [B, L, L] (fp32), in layer order."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.embeddings = Embeddings(config)
        self.layers = nn.ModuleList(EncoderLayer(config) for _ in range(config.num_layers))

    def forward(self, input_ids, attention_mask, type_ids=None, segment_ids=None, output_attentions=False):
        c = self.config
        route = attention_route(c, input_ids.shape[1], input_ids.device, output_attentions)
        fused = epilogue_route(input_ids.device, torch.is_grad_enabled(), compute_dtype(c), c.hidden_size,
                               c.intermediate_size)
        with annotate(f"encoder/route_{route}"):
            return self._forward(input_ids, attention_mask, type_ids, segment_ids, output_attentions, route, fused)

    def _forward(self, input_ids, attention_mask, type_ids, segment_ids, output_attentions, route, fused):
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
        if route == "plain":
            if packed:
                allowed = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
            else:
                allowed = attention_mask[:, None, None, :].bool()
            bias = torch.where(allowed, 0.0, torch.finfo(torch.float32).min).to(torch.float32)
        kernel_mask = kernel_mask.to(torch.int32)
        maps = []
        for layer in self.layers:
            x, probs = layer(x, bias, kernel_mask, packed, route, fused)
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
    ):
        hidden = self.encoder(input_ids, attention_mask, type_ids, segment_ids)
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

    def forward(self, input_ids, attention_mask, type_ids=None):
        hidden = self.encoder(input_ids, attention_mask, type_ids)
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
