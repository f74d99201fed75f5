"""Plain DeepImpact training steps in float32: the reference of the
training cell.

A step: each triple's two documents scored as the sum of the impacts at
the first piece of every document term that is also a query term; the
loss is the cross-entropy of (positive, negative) with the positive as the
label, averaged over the step's triples; the gradient is clipped to a
global norm of ``clip`` (scaled by clip / norm once the norm reaches it);
then one AdamW step (decoupled weight decay, bias-corrected moments), as
the published recipe trains.  Written from those definitions; it imports
nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .encoder import exact_fp32, forward, padded


def step_loss_and_grads(w: Dict[str, torch.Tensor], config: Dict, tok, triples: Sequence[Tuple[str, str, str]],
                        max_length: int, device, rows: int = 32, fp8: bool = False
                        ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(the step's loss, the gradient of every tensor), the triples taken
    ``rows // 2`` at a time."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in w.items()}
    n = len(triples)
    total = 0.0
    per = max(1, rows // 2)
    with exact_fp32():
        for at in range(0, n, per):
            docs, hits = [], []
            for query, pos, neg in triples[at:at + per]:
                terms = tok.query(query)
                for text in (pos, neg):
                    ids, first = tok.document(text, max_length)
                    docs.append(ids)
                    hits.append([p for t, p in first.items() if t in terms])
            ids, mask = padded(docs, tok.pad, device)
            impacts = forward(params, config, ids, mask, fp8)
            sel = torch.zeros_like(impacts)
            for i, h in enumerate(hits):
                sel[i, h] = 1.0
            scores = (impacts * sel).sum(dim=1).view(-1, 2)
            loss = -torch.log_softmax(scores, dim=1)[:, 0].sum() / n
            loss.backward()
            total += float(loss.detach())
    return total, {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}


def clip_(grads: Dict[str, torch.Tensor], clip: float) -> float:
    norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    if norm >= clip:
        for g in grads.values():
            g.mul_(clip / norm)
    return norm


class AdamW:
    """AdamW with decoupled weight decay and bias-corrected moments."""

    def __init__(self, lr: float, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.01):
        self.lr, self.betas, self.eps, self.wd = lr, betas, eps, weight_decay
        self.t = 0
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        b1, b2 = self.betas
        for k, g in grads.items():
            m = self.m.setdefault(k, torch.zeros_like(g))
            v = self.v.setdefault(k, torch.zeros_like(g))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p = w[k]
            p.mul_(1 - self.lr * self.wd)
            denom = (v / (1 - b2 ** self.t)).sqrt_().add_(self.eps)
            p.addcdiv_(m, denom, value=-self.lr / (1 - b1 ** self.t))


def train_steps(w0: Dict[str, torch.Tensor], config: Dict, tok, steps: List[Sequence[Tuple[str, str, str]]],
                max_length: int, lr: float, weight_decay: float, clip: float, device, fp8: bool = False) -> Dict:
    """Run ``steps`` (each a list of (query, positive, negative) texts) from
    the weights ``w0`` (``fp8``: the control, see ``encoder.forward``).  Returns each step's loss, the first step's clipped
    gradient by tensor, and the change of every tensor after the last."""
    w = {k: v.detach().clone() for k, v in w0.items()}
    opt = AdamW(lr, weight_decay=weight_decay)
    losses, first_grads = [], None
    for triples in steps:
        loss, grads = step_loss_and_grads(w, config, tok, triples, max_length, device, fp8=fp8)
        clip_(grads, clip)
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        opt.step(w, grads)
        losses.append(loss)
    return {"losses": losses, "first_grads": first_grads,
            "change": {k: w[k] - w0[k] for k in w0}}
