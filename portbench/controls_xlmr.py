#!/usr/bin/env python3
"""The controls of the XLM-R encode cell's output checks, at the cell's own
size.

    python3 portbench/controls_xlmr.py --workload encode-xlmr-docs512 --seeds <n> [<n> ...] \\
        [--seconds <s>] [--rate <docs/s>]

Each control puts a faulty reference in the program's place and reads the
cell's checked numbers from it exactly as a run reads them from the
program's forward file (impacts rounded to 3 decimals): the reference one
precision below the configuration's bfloat16 (``fp8``: float8 e4m3
products), half of each batch never computed (``half_batch``), and the
model's state left as drawn, the impact head's calibration lost
(``unchanged_state``: the head's weight as first drawn, its bias 0).  Each is
judged by the cell's own limits (``controls.judge``) and must come out
``correct: false``.  The sample is the one a run at ``--rate`` documents/s
over ``--seconds`` would check.  The benchmark's own runs never run this;
``portbench/tests`` runs it at a small size.

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


def encode_xlmr_control(cell, expected_rate: float) -> dict:
    """Each fault's impact gaps over the sample a run of ``expected_rate``
    documents/s would check."""
    import torch

    from portbench.drivers.encode_xlmr import reference_impacts, sample
    from portbench.harness import encoder_setup, xlmr_setup
    from portbench.reference.encoder import HEAD
    from portbench.reference.encoder_xlmr import make_weights

    cfg, tr = cell.config, cell.workload["traffic"]
    dev = torch.device(cell.device)
    src = xlmr_setup.source(cfg, tr)
    weights = xlmr_setup.weights(cfg, cell.seed, dev, src)
    texts, _, _, lengths = src.draw(int(expected_rate * cell.seconds), cell.seed)
    picks = sample(lengths, int(cell.workload["check"]["sample_every"]), cell.seed)
    docs = [texts[i] for i in picks]
    length = int(tr["max_length"])
    want = dict(enumerate(reference_impacts(cfg, weights, src, docs, length, dev)))
    drawn = dict(weights)
    drawn[f"{HEAD}.weight"] = make_weights(cfg, cell.seed + 1, dev)[f"{HEAD}.weight"]
    drawn[f"{HEAD}.bias"] = torch.zeros_like(weights[f"{HEAD}.bias"])
    faults = {"fp8": (weights, {"fp8": True}), "half_batch": (weights, {"half_batch": True}),
              "unchanged_state": (drawn, {})}
    out = {}
    for name, (w, fault) in faults.items():
        got = reference_impacts(cfg, w, src, docs, length, dev, **fault)
        got = {i: {t: round(v, 3) for t, v in row.items()} for i, row in enumerate(got)}
        out[name] = encoder_setup.impact_gaps(got, want)
    return out


def main(argv=None, device: str = "cuda", overrides=None) -> int:
    from portbench.controls import judge

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", default="encode-xlmr-docs512")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=None, help="the window the sample is drawn for")
    p.add_argument("--rate", type=float, default=None, help="the rate the sample is drawn for")
    args = p.parse_args(argv)
    common.set_environment()
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    workload = common.load_json(common.BENCH / "workloads" / f"{args.workload}.json")
    if workload["driver"] != "encode_xlmr":
        raise SystemExit(f"{args.workload} is not an XLM-R encode cell: use portbench/controls.py")
    config_entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = common.load_json(common.ROOT / config_entry["file"])
    for key, value in (overrides or {}).items():
        (config if key == "config" else workload.setdefault(key, {})).update(value)
    seconds = args.seconds or bench["run_seconds"]
    for seed in args.seeds:
        cell = common.Cell(name=args.workload, seed=seed, seconds=seconds, trace=False, device=device,
                           workload=workload, config=config, tmpdir=Path("."), started=0.0)
        got = encode_xlmr_control(cell, args.rate or float(workload["traffic"]["max_rate"]))
        print(json.dumps({"workload": args.workload, "seed": seed, "control": judge(cell, got)},
                         default=lambda x: None if isinstance(x, float) and math.isnan(x) else x), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
