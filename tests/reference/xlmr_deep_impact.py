"""A plain XLM-R DeepImpact forward in float32 torch: the reference the
port's XLM-R encoder is held to in the CPU tests.

Written from the published model (``xlm-roberta-base``'s RoBERTa
embeddings: word + position + the one token type, positions counting from
``pad_token_id + 1`` over the real tokens; post-LayerNorm layers; exact
GELU) and the fork's head (``xlmr_original.py:31-85``: ``Linear(hidden,
1)`` on every token, then Softplus).  Weights are a dict in HuggingFace's
layout (``roberta.`` names, head ``impact_score_encoder.0``), the layout
``xlmr_original.py`` loads.  It imports nothing but ``torch``, and runs
with TF32 off.

Departures from the published model: no dropout (inference), and packed
rows: ``segments`` number each row's documents from 1 (0 on padding), the
positions restart at every document and attention is block-diagonal, so a
document's impacts are those it has alone in a row.
"""

import math
from typing import Dict

import torch
import torch.nn.functional as F

HEAD = "impact_score_encoder.0"


def weight_shapes(config: Dict) -> Dict[str, tuple]:
    """Every tensor of the trunk and the head, in HuggingFace's names."""
    h, f = config["hidden_size"], config["intermediate_size"]
    e = "roberta.embeddings"
    out = {f"{e}.word_embeddings.weight": (config["vocab_size"], h),
           f"{e}.position_embeddings.weight": (config["max_position_embeddings"], h),
           f"{e}.token_type_embeddings.weight": (config["type_vocab_size"], h),
           f"{e}.LayerNorm.weight": (h,), f"{e}.LayerNorm.bias": (h,)}
    for i in range(config["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}"
        for name, rows, cols in (("attention.self.query", h, h), ("attention.self.key", h, h),
                                 ("attention.self.value", h, h), ("attention.output.dense", h, h),
                                 ("intermediate.dense", f, h), ("output.dense", h, f)):
            out[f"{p}.{name}.weight"], out[f"{p}.{name}.bias"] = (rows, cols), (rows,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            out[f"{p}.{name}.weight"], out[f"{p}.{name}.bias"] = (h,), (h,)
    out[f"{HEAD}.weight"], out[f"{HEAD}.bias"] = (1, h), (1,)
    return out


def make_weights(config: Dict, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights: every tensor N(0, 0.2), LayerNorm scales
    around 1 (so every parameter takes part in the comparison)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, shape in weight_shapes(config).items():
        out[k] = torch.randn(shape, generator=g) * 0.2 + (1.0 if k.endswith("LayerNorm.weight") else 0.0)
    return out


def position_ids(segments: torch.Tensor, pad: int) -> torch.Tensor:
    """``pad + 1`` plus each token's index within its document; ``pad`` on
    padding."""
    out = torch.full_like(segments, pad)
    for b in range(segments.shape[0]):
        at, prev = 0, 0
        for j, s in enumerate(segments[b].tolist()):
            at = 0 if s != prev else at
            prev = s
            if s > 0:
                out[b, j] = pad + 1 + at
            at += 1
    return out


def forward(w: Dict[str, torch.Tensor], config: Dict, ids: torch.Tensor, segments: torch.Tensor) -> torch.Tensor:
    """Impacts [B, L] (float32) of ``ids`` [B, L] whose ``segments`` [B, L]
    number each row's documents from 1 (0 on padding)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _forward(w, config, ids, segments)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _forward(w, config, ids, segments):
    h, eps = config["hidden_size"], config["layer_norm_eps"]
    heads = config["num_attention_heads"]
    d = h // heads
    b, length = ids.shape

    def norm(x, name):
        return F.layer_norm(x, (h,), w[f"{name}.weight"], w[f"{name}.bias"], eps)

    def linear(x, name):
        return x @ w[f"{name}.weight"].t() + w[f"{name}.bias"]

    e = "roberta.embeddings"
    x = (w[f"{e}.word_embeddings.weight"][ids]
         + w[f"{e}.position_embeddings.weight"][position_ids(segments, config["pad_token_id"])]
         + w[f"{e}.token_type_embeddings.weight"][0])
    x = norm(x, f"{e}.LayerNorm")
    allowed = (segments[:, :, None] == segments[:, None, :])[:, None]
    for i in range(config["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}"
        q, k, v = (linear(x, f"{p}.attention.self.{n}").view(b, length, heads, d).transpose(1, 2)
                   for n in ("query", "key", "value"))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(logits.masked_fill(~allowed, float("-inf")), dim=-1)
        ctx = (probs @ v).transpose(1, 2).reshape(b, length, h)
        x = norm(x + linear(ctx, f"{p}.attention.output.dense"), f"{p}.attention.output.LayerNorm")
        x = norm(x + linear(F.gelu(linear(x, f"{p}.intermediate.dense")), f"{p}.output.dense"),
                 f"{p}.output.LayerNorm")
    return F.softplus(linear(x, HEAD)[..., 0])
