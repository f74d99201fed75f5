"""Pairwise cross-entropy training, the work ``cli.train`` does: the
``Trainer`` it builds (AdamW, clipping at 2.0, no evaluation), fed by its
``BatchLoader`` with the triples collate and sequence packing, ``groups``
triples (2 x ``groups`` documents) a step at ``max_length``.

Set-up builds the one trainer, drives it from the seed through
``warm_steps`` steps through ``Trainer.train`` and the loader, records what
the checks need after its first step and after ``ref_steps``, and hands
the same trainer to the window, which runs steps until ``--seconds`` have
passed.  Every triple of every step differs.  The checkpoint manager is
set not to write (``writer=False``, as on a data-parallel rank other than
0): the cell measures training steps, not snapshot writes.  The rate is
every document of every step over the whole window.

Traffic parameters: ``words``, ``mean_words`` (the text), ``query_words``,
``groups``, ``max_length``, ``lr``, ``weight_decay``, ``clip``,
``warm_steps``, ``ref_steps``, ``max_steps_per_s``; traced runs add
``trace_steps``.
"""

from __future__ import annotations

import math
import time
from functools import partial
from typing import Dict, List

import numpy as np

from ..harness import encoder_setup
from ..harness.common import Cell, Check, Outcome, log
from ..traffic.passages import make_triples


class Recorder:
    """The dataset as the loader sees it, recording which triples it
    reads, in order."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.seen: List[int] = []

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, i):
        self.seen.append(int(i))
        return self.dataset[i]


class Log:
    """The trainer's metrics logger: each step's loss."""

    def __init__(self):
        self.losses: List[float] = []

    def log(self, record, step=None):
        if "train/loss" in record:
            self.losses.append(float(record["train/loss"]))

    def finish(self):
        pass


def write_inputs(d, passages, queries, triples):
    (d / "collection.tsv").write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(passages)), encoding="utf-8")
    (d / "queries.tsv").write_text("".join(f"{i}\t{q}\n" for i, q in enumerate(queries)), encoding="utf-8")
    (d / "triples.tsv").write_text("".join(f"{q}\t{p}\t{n}\n" for q, p, n in triples), encoding="utf-8")


def leaf_norms(tensors: Dict[str, "object"]) -> Dict[str, float]:
    import torch

    names = list(tensors)
    norms = torch.stack([tensors[k].float().norm() for k in names]).tolist()
    return dict(zip(names, norms))


def loss_gaps(got: List[float], want: List[float]) -> List[float]:
    """Each step's |program's loss - reference's|, over the larger of that
    step's reference loss and the first step's.  The loss falls toward 0
    within three steps here (0.24 -> 0.001), and a loss that small is the
    exponential of the score margin: its relative error is the margin's
    absolute error, which grows with the margin; the first step's loss is
    a scale that does not vanish."""
    return [abs(a - b) / max(abs(b), abs(want[0])) for a, b in zip(got, want)]


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    """The largest |program's norm - reference's norm| over the leaves in
    ``keep``, each over the larger of that leaf's reference norm and the
    median leaf's."""
    median = float(np.median([want[k] for k in keep]))
    return max(abs(got[k] - want[k]) / max(want[k], median) for k in keep)


def run(cell: Cell) -> Outcome:
    import torch

    from improving_learned_index_tpu_torch.core.config import TrainConfig
    from improving_learned_index_tpu_torch.data.datasets import MSMarcoTriples
    from improving_learned_index_tpu_torch.parallel.dataloader import BatchLoader
    from improving_learned_index_tpu_torch.train.collate import collate_triples
    from improving_learned_index_tpu_torch.train.packed import packing_collate
    from improving_learned_index_tpu_torch.train.trainer import Trainer

    cfg, tr = cell.config, cell.workload["traffic"]
    dev = torch.device(cell.device)
    groups, length = int(tr["groups"]), int(tr["max_length"])
    warm_steps, ref_steps = int(tr["warm_steps"]), int(tr["ref_steps"])
    trace_steps = int(tr["trace_steps"]) if cell.trace else 0
    steps = warm_steps + math.ceil(cell.seconds * float(tr["max_steps_per_s"])) + trace_steps
    n = steps * groups
    encoder_setup.build_kernels(dev)
    src = encoder_setup.source(cfg, tr)
    passages, ids, ends, lengths = src.draw(2 * n, cell.seed)
    queries, triples = make_triples(passages, n, tr, cell.seed)
    write_inputs(cell.tmpdir, passages, queries, triples)
    weights = encoder_setup.weights(cfg, cell.seed, dev, src)
    model = encoder_setup.model(cfg, weights, src.vocab, length, dev)
    dataset = Recorder(MSMarcoTriples(cell.tmpdir / "triples.tsv", cell.tmpdir / "queries.tsv",
                                      cell.tmpdir / "collection.tsv"))
    collate = packing_collate(partial(collate_triples, tokenizer=model.tokenizer, max_length=length))
    loader = BatchLoader(dataset, groups, collate, shuffle=True, seed=cell.seed, drop_last=True)
    config = TrainConfig(batch_size=groups, lr=float(tr["lr"]), seed=cell.seed, max_length=length,
                         save_every=1 << 62, weight_decay=float(tr["weight_decay"]),
                         grad_clip_norm=float(tr["clip"]), loss="pairwise_ce")
    metrics_log = Log()
    trainer = Trainer(model, config, cell.tmpdir / "checkpoints", metrics_logger=metrics_log)
    trainer.manager.writer = False
    names = [k for k, _ in model.module.named_parameters()]
    start = {k: p.detach().clone() for k, p in model.module.named_parameters()}
    seen = {}
    clock = {"steps": 0}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def feed(batches, deadline=None, limit=None):
        """Batches for ``Trainer.train``; asked for batch k + 1, step k is
        done (its loss was read), its optimizer step queued after it."""
        for batch in batches:
            done = clock["steps"]
            if done == 1 and "grads" not in seen:
                # the first gradient as AdamW got it: exp_avg = (1 - beta1) g
                b1 = trainer.optimizer.param_groups[0]["betas"][0]
                state = trainer.optimizer.state
                # (a leaf the optimizer holds no state for got no step)
                seen["grads"] = leaf_norms({k: state[p]["exp_avg"] / (1 - b1) if "exp_avg" in state.get(p, {})
                                            else torch.zeros(()) for k, p in zip(names, trainer.params)})
            if done == ref_steps and "change" not in seen:
                seen["change"] = leaf_norms({k: p.detach() - start[k]
                                             for k, p in model.module.named_parameters()})
            if done == warm_steps and "t0" not in clock:
                sync()
                clock["t0"] = cell.open_window()
                clock["at_t0"] = done
            if deadline is not None and "t0" in clock and time.monotonic() >= clock["t0"] + cell.seconds:
                sync()
                clock["t1"] = cell.close_window()
                return
            if limit is not None and clock["steps"] >= limit:
                return
            clock["steps"] += 1
            yield batch

    epoch = loader.epoch(0)
    try:
        trainer.train(feed(epoch, deadline=True, limit=steps - trace_steps), skip=0)
        if "t1" not in clock:
            sync()
            clock["t1"] = cell.close_window()
            log(f"all {steps} steps' triples trained before the window's end: raise max_steps_per_s")
        window_steps = clock["steps"] - clock["at_t0"]
        window_s = clock["t1"] - clock["t0"]
        metrics = {"train_docs_per_s": window_steps * 2 * groups / window_s}
        readings = {}
        if cell.trace:
            from ..harness.trace import Window

            with Window(annotations=("train/forward", "train/optimizer")) as w:
                trainer.train(feed(epoch, limit=clock["steps"] + trace_steps), skip=0)
            w.profile.units = trace_steps
            pieces = encoder_setup.pieces_table(src)
            doc_tokens = src.token_counts(ids, ends, lengths, pieces, length)
            used = dataset.seen[clock["at_t0"] * groups:(clock["at_t0"] + window_steps) * groups]
            tokens = [int(doc_tokens[pid]) for t in used for pid in triples[t][1:]]
            readings = {"profile": w.profile, "window_s": window_s, "window_tokens": tokens, "config": cfg}
    finally:
        epoch.close()
    peak = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0
    losses = metrics_log.losses[:ref_steps]
    first = [dataset.seen[s * groups:(s + 1) * groups] for s in range(ref_steps)]
    del trainer, model, start
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    gaps = compare(cfg, tr, weights, src.vocab, [[(queries[q], passages[p], passages[m])
                                                   for q, p, m in (triples[t] for t in step)] for step in first],
                   losses, seen, dev)
    log(f"{window_steps} steps in {window_s:.3f} s; losses {losses}; {gaps}")
    checks = [Check(name, gaps[name], cell.limit(name)) for name in ("loss_gap", "grad_gap", "change_gap")]
    return Outcome(attempted=window_steps, failed=0, metrics=metrics, checks=checks,
                   memory_peak_bytes=int(peak), readings=readings)


def compare(cfg, tr, weights, vocab, steps, losses, seen, device, fp8: bool = False) -> Dict[str, float]:
    """The program's first steps against the reference's on the same
    triples from the same weights: the largest gap of a step's loss
    (``loss_gaps``), and the worst leaf's gap of the first gradient's norm
    and of the change's norm after the last step, over leaves whose
    reference gradient is at least a thousandth of the median leaf's."""
    from ..reference.tokenizer import Tokenizer
    from ..reference.training import train_steps

    ref = train_steps(weights, cfg, Tokenizer(vocab), steps, int(tr["max_length"]), float(tr["lr"]),
                      float(tr["weight_decay"]), float(tr["clip"]), device, fp8=fp8)
    want_g = leaf_norms(ref["first_grads"])
    want_c = leaf_norms(ref["change"])
    got_g = {encoder_setup.hf_name(k): v for k, v in seen["grads"].items()}
    got_c = {encoder_setup.hf_name(k): v for k, v in seen["change"].items()}
    median = float(np.median(list(want_g.values())))
    keep = [k for k in want_g if want_g[k] >= 1e-3 * median]
    gaps = loss_gaps(losses, ref["losses"])
    return {"loss_gap": max(gaps) if len(losses) == len(steps) else float("nan"),
            "grad_gap": worst_leaf_gap(got_g, want_g, keep), "change_gap": worst_leaf_gap(got_c, want_c, keep),
            "leaves_left_out": len(want_g) - len(keep), "step_loss_gaps": gaps, "reference_losses": ref["losses"]}
