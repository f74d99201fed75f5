"""``BENCHMARK.json`` against the benchmark's rules: names and units,
files found by name, what each per-layer metric moves and where, bounds,
and the length of a full check."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def one_line(text, most=200):
    return isinstance(text, str) and 1 <= len(text) <= most and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert any(w.startswith(BENCH["paths"][0]) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS, ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert one_line(entry[key])


def test_names_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / config["file"]
    assert path.is_file() and config["file"].startswith(tuple(BENCH["paths"]))
    data = json.loads(path.read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    spec = json.loads((ROOT / "portbench" / "workloads" / f"{cell['name']}.json").read_text())
    assert spec["config"] == cell["config"]
    assert (ROOT / "portbench" / "drivers" / f"{spec['driver']}.py").is_file()
    assert set(spec["limits"]) and all(isinstance(v, (int, float)) for v in spec["limits"].values())
    for m in BENCH["per_layer"]:
        if cell["name"] in m.get("workloads", []):
            assert (ROOT / "portbench" / "layer_metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    assert metric["source"] in SOURCES
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["workloads"]


def test_setup_and_per_cell_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"] and e2e["setup_s"]["bound"] <= 0.25
    for cell in BENCH["workloads"]:
        mine = [m for m in BENCH["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
        assert len(mine) >= 2
        assert any(cell["name"] in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_cell_reports_what_it_moves(metric):
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_a_full_check_fits():
    # with the 24 cells later PRs may reach: 2 + 14 x cells runs of
    # run_seconds + 60, 2 x 90 s of compiling a cell, 1200 s spare
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_at_most_a_quarter_on_four_chips():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)
