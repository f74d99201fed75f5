"""Training loop: the port of ``improving_learned_index_tpu/train/trainer.py``.

The same objectives, batch layouts, optimizer, accumulation, checkpoint and
resume semantics as the JAX ``Trainer``, in PyTorch's idiom: the model's
``nn.Module`` holds the parameters, ``loss.backward()`` gives the gradients
and ``torch.optim.AdamW`` steps them.

- The forward is ``model.module`` itself (``DeepImpact.__call__`` and its
  encode methods run under ``torch.inference_mode``).  There is no dropout,
  as the JAX loss runs with ``deterministic=True``; on the card attention is
  the hand-written ``short_attention`` kernel, whose backward recomputes
  through the JAX ``custom_vjp``'s math (``ops/short_attention.py``).
- The optimizer is optax's ``chain(clip_by_global_norm(2.0), adamw(lr,
  weight_decay))``: the clip is done by hand, because optax scales by
  ``max_norm / norm`` once ``norm >= max_norm`` where ``clip_grad_norm_``
  adds 1e-6 to the norm; one AdamW group decays every parameter (optax has
  no mask), betas (0.9, 0.999), eps 1e-8.
- ``grad_norm`` is the micro-batch's global norm before the accumulation
  divide; accumulated gradients are pre-divided by the window and a
  trailing partial window is rescaled by ``accum / window``.
- With a process group of more than one rank the module runs under
  ``DistributedDataParallel``; each rank's batches are its share of the
  global batch (``parallel.distributed``).  Rank 0 writes the checkpoints,
  metrics and evaluations.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.checkpoint import CheckpointManager
from ..core.config import TrainConfig
from ..core.logging import get_logger
from ..core.profiling import annotate
from ..parallel.distributed import rank_and_world
from .losses import distil_kl, distil_margin_mse, pairwise_ce

logger = get_logger("trainer")


def masked_doc_scores(token_scores: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Per-document score: sum of impact scores at query-matching first-token
    positions (reference trainer.py:158-163)."""
    return (masks * token_scores[..., 0]).sum(dim=-1)


def packed_doc_scores(token_scores: torch.Tensor, batch: Dict) -> torch.Tensor:
    """Per-document scores from a sequence-packed batch (train/packed.py):
    the same sum of mask * token_score per document, recovered with one
    ``index_add`` over the packed doc_index map into the zero [N+1]
    ``doc_base`` (padding slots land on the trailing row, dropped)."""
    vals = batch["masks"] * token_scores[..., 0]  # [R, S]
    idx = batch["doc_index"].reshape(-1).long()
    return batch["doc_base"].index_add(0, idx, vals.reshape(-1))[:-1]


def make_loss_fn(module, loss_name: str) -> Callable:
    """Build loss_fn(batch) -> scalar for the given objective, ``batch`` a
    dict of tensors on the module's device; ``module`` is the objective's
    model (``PairwiseImpactModel`` for ``pairwise_impact``,
    ``CrossEncoderModel`` for ``cross_encoder``, else ``DeepImpactModel``).

    Batches carrying ``segment_ids`` (sequence-packed, train/packed.py) take
    the packed forward (block-diagonal attention, per-segment positions)
    for the objectives whose mask is per-document (pairwise_ce, distil_*)."""

    def forward(batch):
        if "segment_ids" in batch:
            seg = batch["segment_ids"]
            return module(batch["input_ids"], (seg > 0).to(torch.int32), batch["type_ids"], segment_ids=seg)
        return module(batch["input_ids"], batch["attention_mask"], batch["type_ids"])

    def doc_scores(token_scores, batch):
        if "segment_ids" in batch:
            return packed_doc_scores(token_scores, batch)
        return masked_doc_scores(token_scores, batch["masks"])

    if loss_name == "pairwise_ce":

        def loss_fn(batch):
            return pairwise_ce(doc_scores(forward(batch), batch).reshape(-1, 2))

    elif loss_name in ("distil_kl", "distil_mse"):
        loss = distil_kl if loss_name == "distil_kl" else distil_margin_mse

        def loss_fn(batch):
            scores = doc_scores(forward(batch), batch)
            return loss(scores.reshape(batch["scores"].shape), batch["scores"])

    elif loss_name == "in_batch_negatives":

        def loss_fn(batch):
            token_scores = forward(batch)[..., 0]  # [2B, L]
            two_b, seq = token_scores.shape
            b = two_b // 2
            ts = token_scores.reshape(b, 2, seq)
            pos = ts[:, 0:1, :]
            negs = ts[None, :, 1, :].expand(b, b, seq)
            combined = torch.cat([pos, negs], dim=1).reshape(b * (b + 1), seq)
            scores = (batch["masks"] * combined).sum(dim=-1).reshape(b, b + 1)
            return pairwise_ce(scores)

    elif loss_name == "pairwise_impact":

        def loss_fn(batch):
            single, pair_scores, pair_attn = module(
                batch["input_ids"], batch["attention_mask"], batch["type_ids"],
                batch["pair_indices"], batch["pair_mask"],
            )
            # attention-weighted pairwise contribution per doc (reference
            # training/pairwise_trainer.py:26-36); pair_attn is detached
            pair_contrib = (pair_scores * pair_attn).sum(dim=-1)
            scores = masked_doc_scores(single, batch["masks"]) + pair_contrib
            return pairwise_ce(scores.reshape(batch["masks"].shape[0] // 2, -1))

    elif loss_name == "cross_encoder":

        def loss_fn(batch):
            return pairwise_ce(forward(batch).reshape(-1, 2))  # [2B, 1] -> [B, 2]

    else:
        raise ValueError(f"unknown loss {loss_name}")

    return loss_fn


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax.global_norm: the l2 norm of every element of every tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm_(
    grads: List[torch.Tensor], max_norm: float, norm: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """optax.clip_by_global_norm in place: unchanged while the global norm is
    below ``max_norm``, else ``g / norm * max_norm`` (no epsilon).  ``norm``,
    when given, is ``global_norm(grads)`` already computed.  Decided on the
    device: no host sync."""
    if norm is None:
        norm = global_norm(grads)
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, 1.0, norm))
    torch._foreach_mul_(grads, torch.where(keep, 1.0, max_norm))
    return norm


def _pulled(batches: Iterable[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
    """``batches``, each pull in the region ``train/next_batch`` (the wait
    on the loader)."""
    it = iter(batches)
    end = object()
    while True:
        with annotate("train/next_batch"):
            batch = next(it, end)
        if batch is end:
            return
        yield batch


class Trainer:
    """Owns the optimizer/step/checkpoint lifecycle around the module."""

    def __init__(
        self,
        model,  # models.DeepImpact, DeepImpactCrossEncoder or DeepPairwiseImpact
        config: TrainConfig,
        checkpoint_dir,
        evaluator=None,
        metrics_logger=None,  # core.metrics_log.MetricsLogger
    ):
        self.model = model
        self.config = config
        self.device = model.device
        self.evaluator = evaluator
        self.checkpoint_dir = Path(checkpoint_dir)
        self.metrics_logger = metrics_logger
        self.rank, self.world = rank_and_world()

        module = model.module
        self.params = list(module.parameters())
        self.optimizer = torch.optim.AdamW(
            self.params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay,
        )
        if self.world > 1:
            from torch.nn.parallel import DistributedDataParallel

            ids = [self.device.index or torch.cuda.current_device()] if self.device.type == "cuda" else None
            module = DistributedDataParallel(module, device_ids=ids)
        self.module = module
        self.manager = CheckpointManager(
            checkpoint_dir,
            name=type(model).__name__,
            save_every=config.save_every,
            save_best=config.save_best,
            batch_size=config.batch_size,  # query groups per step (global)
            writer=self.rank == 0,
        )
        self.loss_fn = make_loss_fn(module, config.loss)

    # -- device placement -------------------------------------------------------
    def _put_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        with annotate("train/put_batch"):
            for k, v in batch.items():
                if k == "group_size":
                    continue  # metadata
                t = torch.from_numpy(np.ascontiguousarray(v))
                if self.device.type == "cuda":
                    t = t.pin_memory().to(self.device, non_blocking=True)
                out[k] = t
        return out

    # -- one micro-batch ----------------------------------------------------------
    def _grad_step(self, batch: Dict[str, torch.Tensor]):
        """(loss, grad_norm, grads) of one micro-batch: the loss averaged
        over ranks, the gradients as DDP leaves them (averaged)."""
        for p in self.params:
            p.grad = None
        with annotate("train/forward"):
            loss = self.loss_fn(batch)
        with annotate("train/backward"):
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        loss = loss.detach()
        if self.world > 1:
            dist.all_reduce(loss)
            loss = loss / self.world
        return loss, global_norm(grads), grads

    def _apply_grads(self, grads: List[torch.Tensor], norm: Optional[torch.Tensor] = None) -> None:
        """Clip (by ``norm`` when the caller has it) and take one AdamW step."""
        with annotate("train/optimizer"):
            clip_by_global_norm_(grads, self.config.grad_clip_norm, norm)
            for p, g in zip(self.params, grads):
                p.grad = g
            self.optimizer.step()
            for p in self.params:
                p.grad = None

    def _state(self):
        return self.model.module.state_dict(), self.optimizer.state_dict()

    # -- resume ------------------------------------------------------------------
    def maybe_resume(self) -> int:
        """Restore the latest snapshot; returns the number of *batches*
        already consumed (manager.step counts optimizer steps, so
        micro-batches = step x accum; rescaled if the global batch changed --
        reference trainer.py:63-66)."""
        if not self.manager.exists():
            return 0
        restored = self.manager.load()
        self.model.module.load_state_dict(restored["params"])
        if restored["opt_state"] is not None:
            self.optimizer.load_state_dict(restored["opt_state"])
        self.manager.rescale_step_for_batch(self.config.batch_size)
        return self.manager.step * max(1, self.config.grad_accumulation_steps)

    # -- training loop -----------------------------------------------------------
    def train(
        self,
        batches: Iterable[Dict[str, Any]],
        total_steps: Optional[int] = None,
        skip: Optional[int] = None,
    ):
        """``batches``: iterable of collated batches (one micro-batch each;
        under a process group, this rank's share of each).  Resumes by
        skipping already-seen batches, like the reference's dataloader
        skip-replay (trainer.py:92-96,169-181).  ``skip`` overrides the
        resume-derived count (multi-epoch callers pass the within-epoch
        offset; a fresh epoch passes 0).

        Accumulation semantics: the window counter starts at 0 *after* the
        skipped batches (so a resume with skip % accum != 0 still fills a full
        window before stepping), a trailing partial window is flushed as the
        mean of its gradients, and ``manager.on_step`` / metrics count
        optimizer steps, not micro-batches.  Each metrics record also holds
        ``train/elapsed_s``, the seconds since this call started, read after
        the step's loss reached the host."""
        cfg = self.config
        if skip is None:
            skip = self.maybe_resume()
        accum = max(1, cfg.grad_accumulation_steps)
        writer = self.rank == 0

        accum_grads = None
        window = 0  # micro-batches in the current accumulation window
        train_loss = 0.0
        start = time.time()
        micro = 0  # processed micro-batches this call (excludes skipped)
        loss_val = 0.0

        def apply_window():
            nonlocal accum_grads, window
            grads = accum_grads
            if window != accum:
                # Partial (trailing/flush) window: grads were pre-divided by
                # accum; rescale so the update is the mean over `window`.
                grads = [g * (accum / window) for g in grads]
            self._apply_grads(grads)
            accum_grads = None
            window = 0

        for i, batch in enumerate(_pulled(batches)):
            if i < skip:
                continue
            if total_steps is not None and micro >= total_steps:
                break
            loss, grad_norm, grads = self._grad_step(self._put_batch(batch))
            micro += 1
            # the step's end, from the loss's read (which waits for the step)
            # to the metrics record; the optimizer's own region nests inside
            with annotate("train/step_end"):
                loss_val = float(loss)
                train_loss += loss_val
                stepped = False
                if accum > 1:
                    grads = [g / accum for g in grads]
                    accum_grads = grads if accum_grads is None else [a + g for a, g in zip(accum_grads, grads)]
                    window += 1
                    if window == accum:
                        apply_window()
                        stepped = True
                else:
                    # the window is this micro-batch: its norm is the clip's norm
                    self._apply_grads(grads, grad_norm)
                    stepped = True

                if writer and self.evaluator is not None and i % cfg.eval_every == 0:
                    # The eval is a full training stall; record its cost next to
                    # its results so operators can tune the cadence trade-off.
                    t_eval = time.time()
                    metrics = self.evaluator.evaluate_all(self.model)
                    eval_s = round(time.time() - t_eval, 2)
                    record = {"iteration": i, "metrics": metrics,
                              "eval_stall_seconds": eval_s}
                    logger.info(f"eval at iteration {i} ({eval_s}s stall): {metrics}")
                    with open(self.checkpoint_dir / "metrics.txt", "a") as f:
                        f.write(json.dumps(record, default=str) + "\n")
                    if self.metrics_logger is not None:
                        self.metrics_logger.log(
                            {"eval": metrics, "eval/stall_seconds": eval_s},
                            step=self.manager.step,
                        )

                if stepped:
                    self.manager.on_step(*self._state(), metric=loss_val)
                    if writer and self.metrics_logger is not None:
                        self.metrics_logger.log(
                            {
                                "train/loss": loss_val,
                                "train/avg_loss": train_loss / micro,
                                "train/grad_norm": float(grad_norm),
                                "train/lr": cfg.lr,
                                "train/elapsed_s": time.time() - start,
                            },
                            step=self.manager.step,
                        )
            if micro % 50 == 0:
                rate = micro / (time.time() - start)
                logger.info(
                    f"batch {micro} loss {loss_val:.4f} avg {train_loss / micro:.4f} "
                    f"[{rate:.2f} batches/s]"
                )

        if accum_grads is not None:
            # Flush the trailing partial accumulation window.
            apply_window()
            self.manager.on_step(*self._state(), metric=loss_val)

        self.manager.save("final", *self._state())
        return train_loss / max(micro, 1)
