"""A plain BERT encoder with the DeepImpact head, in float32: the
reference of the encode and training cells.

Written from the published architecture (``bert-base-uncased``: post-norm
layers, exact GELU, learned absolute positions, token types) and the
DeepImpact head (one ``Linear(hidden, 1)`` on every token, then ReLU).
Weights are a dict in HuggingFace's layout, the one the benchmark makes
them in.  TF32 is off while it runs.  It imports nothing of the program.

``fp8=True`` is the control: every matrix product takes its two operands
rounded to float8 e4m3 with one scale a tensor (its largest magnitude at
e4m3's largest, 448), the precision below the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

HEAD = "impact_score_encoder.0"


def weight_shapes(config: Dict) -> Dict[str, tuple]:
    """Every tensor of the trunk and the head, in HuggingFace's names."""
    h, f = config["hidden_size"], config["intermediate_size"]
    out = {
        "bert.embeddings.word_embeddings.weight": (config["vocab_size"], h),
        "bert.embeddings.position_embeddings.weight": (config["max_position_embeddings"], h),
        "bert.embeddings.token_type_embeddings.weight": (config["type_vocab_size"], h),
        "bert.embeddings.LayerNorm.weight": (h,),
        "bert.embeddings.LayerNorm.bias": (h,),
    }
    for i in range(config["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        for name, rows, cols in (("attention.self.query", h, h), ("attention.self.key", h, h),
                                 ("attention.self.value", h, h), ("attention.output.dense", h, h),
                                 ("intermediate.dense", f, h), ("output.dense", h, f)):
            out[f"{p}.{name}.weight"] = (rows, cols)
            out[f"{p}.{name}.bias"] = (rows,)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            out[f"{p}.{name}.weight"] = (h,)
            out[f"{p}.{name}.bias"] = (h,)
    out[f"{HEAD}.weight"] = (1, h)
    out[f"{HEAD}.bias"] = (1,)
    return out


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights on ``device``, in one draw: every matrix and
    embedding N(0, initializer_range) (BERT's own initialization, at which
    a random 12-layer trunk keeps its tokens apart and the head scores about
    half the terms above 0), biases 0, LayerNorm scales 1."""
    shapes = weight_shapes(config)
    normal = [k for k, s in shapes.items() if len(s) == 2]
    total = sum(math.prod(shapes[k]) for k in normal)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    flat.mul_(config["initializer_range"])
    out, at = {}, 0
    for k in normal:
        n = math.prod(shapes[k])
        out[k] = flat[at:at + n].view(shapes[k])
        at += n
    for k, s in shapes.items():
        if k not in out:
            out[k] = (torch.ones if k.endswith("LayerNorm.weight") else torch.zeros)(s, device=device)
    return out


@contextlib.contextmanager
def exact_fp32():
    """float32 products without TF32."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def forward(w: Dict[str, torch.Tensor], config: Dict, ids: torch.Tensor, mask: torch.Tensor,
            fp8: bool = False) -> torch.Tensor:
    """Impact of every token, [B, L] float32, for right-padded ``ids``
    [B, L] with ``mask`` [B, L] (True on real tokens)."""
    mm = (lambda a, b: _fp8(a) @ _fp8(b)) if fp8 else torch.matmul
    eps = config["layer_norm_eps"]
    h = config["hidden_size"]
    heads = config["num_attention_heads"]
    d = h // heads
    b, length = ids.shape

    def norm(x, name):
        return F.layer_norm(x, (h,), w[f"{name}.weight"], w[f"{name}.bias"], eps)

    def linear(x, name):
        return mm(x, w[f"{name}.weight"].t()) + w[f"{name}.bias"]

    e = "bert.embeddings"
    x = (w[f"{e}.word_embeddings.weight"][ids] + w[f"{e}.position_embeddings.weight"][:length][None]
         + w[f"{e}.token_type_embeddings.weight"][0])
    x = norm(x, f"{e}.LayerNorm")
    keep = mask[:, None, None, :]
    for i in range(config["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}"
        q, k, v = (linear(x, f"{p}.attention.self.{n}").view(b, length, heads, d).transpose(1, 2)
                   for n in ("query", "key", "value"))
        logits = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
        ctx = mm(probs, v).transpose(1, 2).reshape(b, length, h)
        x = norm(x + linear(ctx, f"{p}.attention.output.dense"), f"{p}.attention.output.LayerNorm")
        inner = F.gelu(linear(x, f"{p}.intermediate.dense"))
        x = norm(x + linear(inner, f"{p}.output.dense"), f"{p}.output.LayerNorm")
    return torch.relu(linear(x, HEAD))[..., 0]


def padded(rows: Sequence[List[int]], pad: int, device):
    """Right-padded ids [B, max len] and their mask."""
    length = max(len(r) for r in rows)
    ids = torch.full((len(rows), length), pad, dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.tensor(r, dtype=torch.long)
    ids = ids.to(device)
    mask = torch.arange(length, device=device)[None, :] < torch.tensor([len(r) for r in rows], device=device)[:, None]
    return ids, mask


@torch.no_grad()
def term_impacts(w, config, tok, texts: Sequence[str], max_length: int, device, fp8: bool = False,
                 rows: int = 64) -> List[Dict[str, float]]:
    """Each text's {term: impact} as the index stores it: the impact of
    the term's first piece, in blocks of ``rows`` texts of like length."""
    docs = [tok.document(t, max_length) for t in texts]
    order = sorted(range(len(docs)), key=lambda i: len(docs[i][0]))
    out: List[Dict[str, float]] = [{} for _ in docs]
    with exact_fp32():
        for at in range(0, len(order), rows):
            block = order[at:at + rows]
            ids, mask = padded([docs[i][0] for i in block], tok.pad, device)
            scores = forward(w, config, ids, mask, fp8).cpu()
            for j, i in enumerate(block):
                out[i] = {t: float(scores[j, pos]) for t, pos in docs[i][1].items()}
    return out
