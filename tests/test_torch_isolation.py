"""The port stands alone: it imports neither JAX, flax nor the JAX package,
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "improving_learned_index_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "improving_learned_index_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert not bad


def test_cpu_query_leaves_jax_unimported(tmp_path):
    code = """
import sys
import numpy as np
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.search.select import build_engine
idx = InvertedIndexData(["a", "b"], np.array([0, 2, 3]), np.array([0, 1, 1], np.uint32),
                        np.array([5, 3, 7], np.uint8), num_docs=2)
idx.save(sys.argv[1])
res = build_engine(sys.argv[1], device="cpu").score_batch([{"a", "b"}], 5)
assert res == [[(1, 10.0), (0, 5.0)]], res
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "idx")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_entry_points_without_cuda_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
    from improving_learned_index_tpu_torch.search.select import build_engine

    idx = InvertedIndexData(["a"], np.array([0, 1]), np.array([0], np.uint32),
                            np.array([5], np.uint8), num_docs=1)
    idx.save(tmp_path / "idx")
    (tmp_path / "q.tsv").write_text("1\ta\n")
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\na\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridSearchEngine(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(tmp_path / "idx")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_main(["--index_path", str(tmp_path / "idx"), "--queries_path", str(tmp_path / "q.tsv"),
                   "--output_path", str(tmp_path / "run"), "--vocab_path", str(tmp_path / "vocab.txt")])
    assert not (tmp_path / "run").exists()
