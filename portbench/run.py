#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Everything is found by name from
``BENCHMARK.json``: the cell's file ``portbench/workloads/<cell>.json``
(its configuration, driver, traffic parameters and check limits), the
configuration's file, its traffic code ``portbench/drivers/<driver>.py``, and
for ``--trace 1`` each per-layer metric's reader
``portbench/layer_metrics/<metric>.py``.  A new cell, configuration,
driver or metric is new files and new entries, never an edit.

The last line of standard output is the result (JSON); the last lines of
standard error are the numbers compared, each beside its limit.  The run
exits non-zero, with no result, without the CUDA cards the cell asks for,
or when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import common  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(name: str, seed: int, seconds: float, trace: bool, device: str, started: float,
              tmpdir: Path) -> tuple:
    """(the cell, its driver module, the benchmark's entries) by name: the
    cell's file, and its configuration's file as ``BENCHMARK.json`` names
    it."""
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    workload = common.load_json(common.BENCH / "workloads" / f"{name}.json")
    config_entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = common.load_json(common.ROOT / config_entry["file"])
    driver = common.load_module(common.BENCH / "drivers" / f"{workload['driver']}.py",
                                f"portbench.drivers.{workload['driver']}")
    cell = common.Cell(name=name, seed=seed, seconds=seconds, trace=trace, device=device, workload=workload,
                       config=config, tmpdir=tmpdir, started=started)
    return cell, driver, bench


def cell_metrics(bench, name: str, trace: bool):
    """The metric entries this cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics."""
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def measure(cell, driver, bench, chips: int):
    """Run the cell's traffic code and read its metrics: (result line, checks)."""
    outcome = driver.run(cell)
    device = device_info(cell.device, chips, outcome.memory_peak_bytes)
    outcome.readings["kind"] = device["kind"]
    metrics = {}
    for m in cell_metrics(bench, cell.name, cell.trace):
        if m["name"] == "setup_s":
            value = cell.setup_s
        elif not cell.trace:
            value = outcome.metrics[m["name"]]
        else:
            reader = common.load_module(common.BENCH / "layer_metrics" / f"{m['name']}.py")
            value = reader.read(outcome.readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    breakdown = None
    profile = outcome.readings.get("profile")
    if cell.trace and profile is not None:
        device["busy_s"] = profile.busy_s
        device["window_s"] = profile.window_s
        breakdown = {"device_ops": profile.device_ops(), "idle_gaps": profile.idle_gaps()}
    return common.result_line(outcome, metrics, device, breakdown), outcome.checks


def device_info(device: str, chips: int, peak: int) -> dict:
    import torch

    if device.startswith("cuda"):
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": int(peak)}


def main(argv=None, device: str = "cuda") -> int:
    """``device`` other than ``cuda`` is for the benchmark's own tests on
    the CPU: it skips the look for a card."""
    started = common.process_start()
    args = parse(argv)
    common.set_environment()
    bench = common.load_json(common.ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        common.log(f"no workload {args.workload!r}")
        return 2
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            common.log(f"{args.workload} needs {entry['chips']} CUDA card(s); "
                       f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 3
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        cell, driver, bench = load_cell(args.workload, args.seed, args.seconds, bool(args.trace), device,
                                        started, Path(tmp))
        line, checks = measure(cell, driver, bench, entry["chips"])
    found = common.forbidden_modules()
    if found:
        common.log(f"forbidden modules loaded in this process: {found}")
        return 4
    common.emit(line, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
