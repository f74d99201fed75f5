"""The import guard, the reference's independence, and the runs that must
print no result: no card, or no program beside the benchmark."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench.harness.common import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["improving_learned_index_tpu_torch.ops", "numpy"]) == []
    assert forbidden_modules(["improving_learned_index_tpu.search"]) == ["improving_learned_index_tpu"]
    assert forbidden_modules(["jax.numpy", "flax", "jaxlib.xla"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping", "flaxen"]) == []


def modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_reference_imports_nothing_of_the_program():
    tops = modules_after("import portbench.reference.encoder, portbench.reference.training, "
                         "portbench.reference.scoring, portbench.reference.tokenizer")
    assert not tops & {"improving_learned_index_tpu_torch", "improving_learned_index_tpu", "jax", "flax", "jaxlib"}


def test_drivers_load_no_jax():
    tops = modules_after("import portbench.drivers.query_batch, "
                         "portbench.drivers.encode, portbench.drivers.train, portbench.controls\n"
                         "import improving_learned_index_tpu_torch.search.hybrid_engine, "
                         "improving_learned_index_tpu_torch.index.indexer, "
                         "improving_learned_index_tpu_torch.train.trainer")
    assert not tops & {"improving_learned_index_tpu", "jax", "flax", "jaxlib"}


def run_cell(cwd: Path):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "query-msmarco-batch", "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        return  # this machine has a card: the run is the benchmark's own
    out = run_cell(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = run_cell(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
