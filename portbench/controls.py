#!/usr/bin/env python3
"""The controls of the output checks, at a cell's own size.

    python3 portbench/controls.py --workload <cell> --seeds <n> [<n> ...] [--seconds <s>]

A control puts the reference, computed one precision below the
configuration's, in the program's place, and reads the cell's checked
numbers from it exactly as a run reads them from the program: the 8-bit
index's answers from 4-bit impacts, the bfloat16 encoder's impacts and
training steps from float8 products.  The training cell also reads the
fault of a step that leaves half of each batch out (the mean over the
rest), planted in the reference, and of a step that leaves the state
unchanged (a change gap of 1, by the measure's definition).  Each number
is compared with the cell's own limit by the run's ``Check``, and each
control must come out ``correct: false``: it is what the limits are set
below.  The benchmark's own runs never run this; ``portbench/tests`` runs
it at a small size.

It prints one JSON line a seed: for each control its checks (value,
limit, passed) and ``correct``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common  # noqa: E402


def query_control(cell, expected_rate: float) -> dict:
    """Mismatched answers of the 4-bit reference, over the sample a run of
    ``expected_rate`` queries/s would check."""
    import torch

    from portbench.harness import index_setup
    from portbench.traffic.index import heavy_terms, make_index, term_names

    cfg, tr = cell.config, cell.workload["traffic"]
    dev = torch.device(cell.device)
    terms = term_names(cfg["num_terms"])
    offsets, docs, vals = make_index(cfg, cell.seed, dev)
    heavy = heavy_terms(offsets[1:] - offsets[:-1], cfg)
    setup = index_setup.IndexSetup(offsets, docs, vals, terms, heavy, None, None)
    n = int(expected_rate * cell.seconds)
    qs, _ = index_setup.queries(setup, n, tr, cell.seed)
    every = int(cell.workload["check"]["sample_every"])
    picks = index_setup.sample(n, every, cell.seed).tolist()
    k = int(tr["k"])
    from portbench.reference.scoring import Scorer

    control = Scorer(offsets, docs, vals, cfg["num_docs"], dev, impact_bits=4)
    sampled = {i: (qs[i], control.topk(qs[i], k)) for i in picks}
    del control
    return {"int4": {"mismatched_answers": index_setup.mismatches(setup, cfg["num_docs"], sampled, k, dev),
                     "sampled": len(sampled)}}


def encode_control(cell, expected_rate: float) -> dict:
    """The fp8 reference's impact gaps over the sample a run of
    ``expected_rate`` passages/s would check."""
    import numpy as np
    import torch

    from portbench.drivers.encode import reference_impacts
    from portbench.harness import encoder_setup

    cfg, tr = cell.config, cell.workload["traffic"]
    dev = torch.device(cell.device)
    src = encoder_setup.source(cfg, tr)
    weights = encoder_setup.weights(cfg, cell.seed, dev, src)
    n = int(expected_rate * cell.seconds)
    texts = src.passages(n, cell.seed)
    rng = np.random.default_rng([int(cell.seed), 6])
    picks = np.nonzero(rng.random(n) < 1.0 / int(cell.workload["check"]["sample_every"]))[0].tolist()
    sample = [texts[i] for i in picks]
    length = int(tr["max_length"])
    want = reference_impacts(cfg, weights, src.vocab, sample, length, dev)
    got = reference_impacts(cfg, weights, src.vocab, sample, length, dev, fp8=True)
    got = [{t: round(v, 3) for t, v in row.items()} for row in got]  # as the forward file holds them
    return {"fp8": encoder_setup.impact_gaps(dict(enumerate(got)), dict(enumerate(want)))}


def train_control(cell) -> dict:
    """The fp8 reference's first steps, and the half-batch fault's, against
    the float32 reference's, read as a run reads the program's."""
    import numpy as np
    import torch

    from portbench.drivers.train import leaf_norms, loss_gaps, worst_leaf_gap
    from portbench.harness import encoder_setup
    from portbench.reference.tokenizer import Tokenizer
    from portbench.reference.training import train_steps
    from portbench.traffic.passages import make_triples

    cfg, tr = cell.config, cell.workload["traffic"]
    dev = torch.device(cell.device)
    groups, ref_steps = int(tr["groups"]), int(tr["ref_steps"])
    src = encoder_setup.source(cfg, tr)
    n = 64 * groups
    passages = src.passages(2 * n, cell.seed)
    queries, triples = make_triples(passages, n, tr, cell.seed)
    order = np.arange(n)
    np.random.default_rng(cell.seed).shuffle(order)  # the loader's epoch-0 order
    steps = [[(queries[q], passages[p], passages[m]) for q, p, m in (triples[t] for t in order[s * groups:(s + 1) * groups])]
             for s in range(ref_steps)]
    weights = encoder_setup.weights(cfg, cell.seed, dev, src)
    tok = Tokenizer(src.vocab)
    args = (cfg, tok)
    kw = dict(max_length=int(tr["max_length"]), lr=float(tr["lr"]), weight_decay=float(tr["weight_decay"]),
              clip=float(tr["clip"]), device=dev)
    ref = train_steps(weights, *args, steps, **kw)
    want_g, want_c = leaf_norms(ref["first_grads"]), leaf_norms(ref["change"])
    median = float(np.median(list(want_g.values())))
    keep = [k for k in want_g if want_g[k] >= 1e-3 * median]
    out = {}
    for name, run in (("fp8", lambda: train_steps(weights, *args, steps, fp8=True, **kw)),
                      ("half_batch", lambda: train_steps(weights, *args, [s[: len(s) // 2] for s in steps], **kw))):
        got = run()
        out[name] = {
            "loss_gap": max(loss_gaps(got["losses"], ref["losses"])),
            "grad_gap": worst_leaf_gap(leaf_norms(got["first_grads"]), want_g, keep),
            "change_gap": worst_leaf_gap(leaf_norms(got["change"]), want_c, keep),
        }
    out["unchanged_state"] = {"change_gap": 1.0}
    out["half_batch"]["leaves_left_out"] = out["fp8"]["leaves_left_out"] = len(want_g) - len(keep)
    return out


def judge(cell, readings: dict) -> dict:
    """Each control's numbers against the cell's limits, as a run's checks
    are judged: its checks and ``correct`` (every check passed)."""
    from portbench.harness.common import Check

    out = {}
    for control, numbers in readings.items():
        checks = [Check(name, numbers[name], cell.limit(name)) for name in cell.workload["limits"]
                  if name in numbers]
        out[control] = {"checks": {c.name: {"value": c.value, "limit": c.limit, "passed": c.passed}
                                   for c in checks},
                        "correct": all(c.passed for c in checks) and bool(checks),
                        **{k: v for k, v in numbers.items() if k not in cell.workload["limits"]}}
    return out


def main(argv=None, device: str = "cuda", overrides=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None, help="the window the sample is drawn for")
    p.add_argument("--rate", type=float, default=None, help="the rate the sample is drawn for")
    args = p.parse_args(argv)
    common.set_environment()
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    workload = common.load_json(common.BENCH / "workloads" / f"{args.workload}.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = common.load_json(common.ROOT / config_entry["file"])
    for key, value in (overrides or {}).items():
        (config if key == "config" else workload.setdefault(key, {})).update(value)
    seconds = args.seconds or bench["run_seconds"]
    for seed in args.seeds:
        cell = common.Cell(name=args.workload, seed=seed, seconds=seconds, trace=False, device=device,
                           workload=workload, config=config, tmpdir=Path("."), started=0.0)
        kind = workload["driver"]
        if kind == "query_batch":
            got = query_control(cell, args.rate or 2000.0)
        elif kind == "encode":
            got = encode_control(cell, args.rate or 8000.0)
        elif kind == "train":
            got = train_control(cell)
        else:
            raise SystemExit(f"no control for driver {kind}")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": judge(cell, got)},
                         default=lambda x: None if isinstance(x, float) and math.isnan(x) else x), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
