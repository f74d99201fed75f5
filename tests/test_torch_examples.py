"""The port's two walkthroughs (``examples/quickstart_torch.py``,
``examples/index_lifecycle_torch.py``) on the CPU, and what they write held
against the JAX package on the same files.

Each runs as a script in a subprocess with ``--device cpu`` and must exit 0
with every step printed.  Then:
- the quickstart's ``inverted/`` loads with the JAX ``InvertedIndexData``,
  and the JAX ``Ranker``'s run over ``queries.tsv`` (and over a query of the
  index's whole vocabulary, which surely hits) equals the port's line for
  line;
- the lifecycle's ``inv_live/`` equals, array for array, the JAX ``merge``
  then ``delete_docs([1])`` over the port-written ``inv_v1/`` and
  ``inv_delta/``.
Without ``--device`` and with CUDA hidden, each exits non-zero with the
port's ``RuntimeError``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from improving_learned_index_tpu.evaluation import Ranker as JaxRanker
from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu_torch.evaluation import Ranker
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

REPO = Path(__file__).resolve().parent.parent
QUICKSTART = REPO / "examples" / "quickstart_torch.py"
LIFECYCLE = REPO / "examples" / "index_lifecycle_torch.py"
QS_STEPS = ("1. expanded 6 documents", "2. merged expansions", "3. impact scores for d0",
            "4. inverted index", "5. metrics", "6. hybrid engine")
LC_STEPS = ("build v1:", "  v1: 4 docs", "add delta", "  delta: 2 docs", "  merged: 6 docs",
            "after delete: 5 docs", "router over 2 shard daemons == single engine", "  stats:", "done.")


def _run(script, *args, env=None):
    return subprocess.run([sys.executable, str(script), *args], capture_output=True, text=True,
                          cwd=REPO.parent, env=env, timeout=300)


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    work = tmp_path_factory.mktemp("quickstart")
    out = _run(QUICKSTART, "--device", "cpu", "--workdir", str(work))
    assert out.returncode == 0, out.stderr[-3000:]
    return work, out.stdout


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    work = tmp_path_factory.mktemp("lifecycle")
    out = _run(LIFECYCLE, "--device", "cpu", "--workdir", str(work))
    assert out.returncode == 0, out.stderr[-3000:]
    return work, out.stdout


def _starts(stdout, steps):
    lines = stdout.splitlines()
    missing = [s for s in steps if not any(line.startswith(s) for line in lines)]
    assert not missing, (missing, stdout[-2000:])


def test_quickstart_prints_every_step(quickstart):
    _starts(quickstart[1], QS_STEPS)


def test_lifecycle_prints_every_step(lifecycle):
    _starts(lifecycle[1], LC_STEPS)


def test_quickstart_run_matches_jax_ranker(quickstart, tmp_path):
    """The JAX ``Ranker`` over the port-written index gives the port's run
    file, over ``queries.tsv`` and over a query of every index term."""
    work, _ = quickstart
    corpus = [line.split("\t", 1)[1] for line in (work / "collection.tsv").read_text().splitlines()]
    index = JaxIndex.load(work / "inverted", num_docs=len(corpus))
    assert index.num_postings > 0
    JaxRanker(index_path=work / "inverted", queries_path=work / "queries.tsv", output_path=tmp_path / "jax.tsv",
              tokenizer=JaxTokenizer(JaxVocab.build(corpus, max_size=1024), max_length=64)).run()
    assert (tmp_path / "jax.tsv").read_text().splitlines() == (work / "run.tsv").read_text().splitlines()
    (tmp_path / "qv.tsv").write_text("qv\t" + " ".join(t for t in index.vocab if not t.startswith("##")) + "\n")
    JaxRanker(index_path=work / "inverted", queries_path=tmp_path / "qv.tsv", output_path=tmp_path / "jax_v.tsv",
              tokenizer=JaxTokenizer(JaxVocab.build(corpus, max_size=1024), max_length=64)).run()
    Ranker(index_path=work / "inverted", queries_path=tmp_path / "qv.tsv", output_path=tmp_path / "port_v.tsv",
           tokenizer=ImpactTokenizer(WordPieceVocab.build(corpus, max_size=1024), max_length=64),
           device="cpu").run()
    want = (tmp_path / "jax_v.tsv").read_text().splitlines()
    assert want and (tmp_path / "port_v.tsv").read_text().splitlines() == want


def test_lifecycle_live_index_matches_jax_algebra(lifecycle):
    work, _ = lifecycle
    v1 = JaxIndex.load(work / "inv_v1", num_docs=4)
    delta = JaxIndex.load(work / "inv_delta", num_docs=2)
    want = JaxIndex.merge([v1, delta]).delete_docs([1])
    got = JaxIndex.load(work / "inv_live", num_docs=want.num_docs)
    assert got.num_docs == want.num_docs == 5 and list(got.vocab) == list(want.vocab)
    for name in ("offsets", "doc_ids", "impacts", "zero_offsets", "zero_doc_ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("script", [QUICKSTART, LIFECYCLE], ids=["quickstart", "lifecycle"])
def test_walkthrough_without_cuda_raises(script, tmp_path):
    out = _run(script, "--workdir", str(tmp_path / "w"), env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "RuntimeError: no CUDA device" in out.stderr, out.stderr[-2000:]
    assert not (tmp_path / "w").exists()
