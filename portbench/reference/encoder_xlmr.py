"""A plain XLM-R encoder with the Softplus DeepImpact head, in float32: the
reference of the XLM-R encode cell.

Written from the published architecture (``xlm-roberta-base``: RoBERTa
embeddings, whose positions count from ``pad_token_id + 1`` over the real
tokens, one token type, post-norm layers, exact GELU) and the fork's head
(``xlmr_original.py``: one ``Linear(hidden, 1)`` on every token, then
Softplus).  Weights are a dict in HuggingFace's layout (``roberta.``
names, head ``impact_score_encoder.0``).  TF32 is off while it runs.  It
imports nothing of the program.

Departures from the published model: no dropout (inference), and the
block-diagonal mask and per-segment positions of packed rows (each
segment is one document, as if alone in its row).

``fp8=True`` is the control one precision down: every matrix product takes
its operands rounded to float8 e4m3 (``reference.encoder``'s rounding).
``half_batch`` is a planted fault of the controls: the second half of each
block's rows never computed (their impacts the head's on a zero state).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from .encoder import HEAD, _fp8, exact_fp32, make_weights as bert_weights
from .unigram import UnigramTokenizer


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights in XLM-R's names: ``reference.encoder``'s
    draw (every matrix and embedding N(0, initializer_range), biases 0,
    LayerNorm scales 1) at this configuration's shapes."""
    return {k.replace("bert.", "roberta.", 1): v for k, v in bert_weights(config, seed, device).items()}


def position_ids(segments: torch.Tensor, pad: int) -> torch.Tensor:
    """RoBERTa positions of rows of segments (0 on padding): ``pad + 1``
    plus the index within the token's segment, ``pad`` on padding."""
    b, length = segments.shape
    idx = torch.arange(length, device=segments.device).expand(b, length)
    start = torch.ones_like(segments, dtype=torch.bool)
    start[:, 1:] = segments[:, 1:] != segments[:, :-1]
    first = torch.cummax(torch.where(start, idx, torch.zeros_like(idx)), dim=1).values
    return torch.where(segments > 0, idx - first + pad + 1, torch.full_like(idx, pad))


def forward(w: Dict[str, torch.Tensor], config: Dict, ids: torch.Tensor, segments: torch.Tensor,
            fp8: bool = False, head: bool = True) -> torch.Tensor:
    """Impact of every token, [B, L] float32, of ``ids`` [B, L] whose
    ``segments`` [B, L] number the documents of each row from 1 (0 on
    padding); ``head=False`` gives the head's input to the Softplus."""
    mm = (lambda a, b: _fp8(a) @ _fp8(b)) if fp8 else torch.matmul
    eps, h = config["layer_norm_eps"], config["hidden_size"]
    heads = config["num_attention_heads"]
    d = h // heads
    b, length = ids.shape

    def norm(x, name):
        return F.layer_norm(x, (h,), w[f"{name}.weight"], w[f"{name}.bias"], eps)

    def linear(x, name):
        return mm(x, w[f"{name}.weight"].t()) + w[f"{name}.bias"]

    e = "roberta.embeddings"
    x = (w[f"{e}.word_embeddings.weight"][ids]
         + w[f"{e}.position_embeddings.weight"][position_ids(segments, config["pad_token_id"])]
         + w[f"{e}.token_type_embeddings.weight"][0])
    x = norm(x, f"{e}.LayerNorm")
    keep = (segments[:, :, None] == segments[:, None, :])[:, None]
    for i in range(config["num_hidden_layers"]):
        p = f"roberta.encoder.layer.{i}"
        q, k, v = (linear(x, f"{p}.attention.self.{n}").view(b, length, heads, d).transpose(1, 2)
                   for n in ("query", "key", "value"))
        logits = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
        probs = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
        ctx = mm(probs, v).transpose(1, 2).reshape(b, length, h)
        x = norm(x + linear(ctx, f"{p}.attention.output.dense"), f"{p}.attention.output.LayerNorm")
        inner = F.gelu(linear(x, f"{p}.intermediate.dense"))
        x = norm(x + linear(inner, f"{p}.output.dense"), f"{p}.output.LayerNorm")
    z = linear(x, HEAD)[..., 0]
    return F.softplus(z) if head else z


def padded(rows: Sequence[List[int]], pad: int, device):
    """Right-padded ids [B, max len] and their segments (1 on each row's
    tokens, one document a row)."""
    length = max(len(r) for r in rows)
    ids = torch.full((len(rows), length), pad, dtype=torch.long)
    for i, r in enumerate(rows):
        ids[i, : len(r)] = torch.tensor(r, dtype=torch.long)
    lens = torch.tensor([len(r) for r in rows])
    segments = (torch.arange(length)[None, :] < lens[:, None]).long()
    return ids.to(device), segments.to(device)


@torch.no_grad()
def term_impacts(w, config, tok: UnigramTokenizer, texts: Sequence[str], max_length: int, device,
                 fp8: bool = False, half_batch: bool = False, rows: int = 64) -> List[Dict[str, float]]:
    """Each text's {term: impact} as the index stores it: the impact of
    the term's first piece, each document alone in its row, in blocks of
    ``rows`` documents of like length."""
    docs = [tok.document(t, max_length) for t in texts]
    order = sorted(range(len(docs)), key=lambda i: len(docs[i][0]))
    out: List[Dict[str, float]] = [{} for _ in docs]
    with exact_fp32():
        for at in range(0, len(order), rows):
            block = order[at:at + rows]
            ids, segments = padded([docs[i][0] for i in block], tok.pad, device)
            scores = forward(w, config, ids, segments, fp8)
            if half_batch:
                scores[len(block) // 2:] = F.softplus(w[f"{HEAD}.bias"])
            scores = scores.cpu()
            for j, i in enumerate(block):
                out[i] = {t: float(scores[j, pos]) for t, pos in docs[i][1].items()}
    return out
