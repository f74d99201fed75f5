"""The port's query CLIs against the JAX package's on the same files:
``cli.rank`` with every ``--engine`` (the card engines with ``--device
cpu``), ``cli.evaluate``, ``cli.aggregate_run`` and the MaxP passaging of
``search.maxp``: byte-identical outputs."""

import json

import numpy as np
import pytest

from improving_learned_index_tpu.cli.aggregate_run import main as jax_aggregate_main
from improving_learned_index_tpu.cli.evaluate import main as jax_evaluate_main
from improving_learned_index_tpu.cli.rank import main as jax_rank_main
from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.search import maxp as jax_maxp
from improving_learned_index_tpu.text.wordpiece import WordPieceVocab as JaxVocab
from improving_learned_index_tpu_torch.cli.aggregate_run import main as aggregate_main
from improving_learned_index_tpu_torch.cli.evaluate import main as evaluate_main
from improving_learned_index_tpu_torch.cli.rank import main as rank_main
from improving_learned_index_tpu_torch.search import maxp


@pytest.fixture
def ranked_inputs(tmp_path):
    """A 600-doc quantized index (ties at the boundary are likely: impacts
    1..20), its vocab, 40 queries and qrels."""
    rng = np.random.default_rng(21)
    per_doc = {}
    for t, d, v in zip(rng.integers(0, 40, 6000), rng.integers(0, 600, 6000), rng.integers(1, 21, 6000)):
        per_doc.setdefault(int(d), {})[f"w{t}"] = int(v)
    JaxIndex.build(sorted(per_doc.items()), num_docs=600).save(tmp_path / "index")
    JaxVocab.build([" ".join(f"w{t}" for t in range(40))], max_size=64).save(tmp_path / "vocab.txt")
    queries = [" ".join(f"w{t}" for t in rng.choice(40, int(rng.integers(1, 5)))) for _ in range(40)]
    (tmp_path / "queries.tsv").write_text(
        "".join(f"q{i}\t{q}\n" for i, q in enumerate(queries + ["unknownword"])), encoding="utf-8"
    )
    (tmp_path / "qrels.tsv").write_text(
        "".join(f"q{i}\t0\t{int(d)}\t1\n" for i, d in enumerate(rng.integers(0, 600, 40))),
        encoding="utf-8",
    )
    return tmp_path


def _rank_args(d, out, k="25"):
    return ["--index_path", str(d / "index"), "--queries_path", str(d / "queries.tsv"),
            "--vocab_path", str(d / "vocab.txt"), "--top_k", k, "--output_path", str(d / out)]


@pytest.mark.parametrize("engine", ["auto", "device", "hybrid", "host", "native"])
def test_rank_engines_write_the_jax_run_file(ranked_inputs, engine):
    d = ranked_inputs
    assert jax_rank_main(_rank_args(d, "jax.run") + ["--engine", "host"]) == 0
    args = _rank_args(d, f"{engine}.run") + ["--engine", engine]
    if engine not in ("host", "native"):
        args += ["--device", "cpu"]
    assert rank_main(args) == 0
    got, want = (d / f"{engine}.run").read_bytes(), (d / "jax.run").read_bytes()
    assert got == want and len(want.splitlines()) > 500
    if engine == "native":
        assert jax_rank_main(_rank_args(d, "jax_native.run") + ["--engine", "native"]) == 0
        assert got == (d / "jax_native.run").read_bytes()


def test_rank_approx_top_k_raises(ranked_inputs):
    with pytest.raises(ValueError, match="approximate"):
        rank_main(_rank_args(ranked_inputs, "x.run") + ["--approx_top_k", "--engine", "host"])
    assert not (ranked_inputs / "x.run").exists()


def test_evaluate_cli_prints_the_jax_metrics(ranked_inputs, capsys):
    d = ranked_inputs
    assert rank_main(_rank_args(d, "run", k="100") + ["--engine", "host"]) == 0
    args = ["--run_file_path", str(d / "run"), "--qrels_path", str(d / "qrels.tsv")]
    capsys.readouterr()
    for extra in ([], ["--mrr_depths", "5", "10", "--recall_depths", "1", "50"]):
        assert jax_evaluate_main(args + extra) == 0
        want = capsys.readouterr().out
        assert evaluate_main(args + extra) == 0
        got = capsys.readouterr().out
        assert got == want and json.loads(got)


def test_maxp_and_aggregate_cli_equal_jax(tmp_path, capsys):
    rng = np.random.default_rng(22)
    words = [f"x{i}" for i in range(50)]
    docs = [(f"D{i}", " ".join(rng.choice(words, int(rng.integers(5, 700))))) for i in range(12)]
    expansion = {"D3": "extra terms", "D7": "more"}
    for window, stride in ((250, 100), (40, 15)):
        assert list(maxp.passage_collection(docs, expansion, window, stride)) == list(
            jax_maxp.passage_collection(docs, expansion, window, stride))
    n = maxp.write_passage_files(docs, tmp_path / "c.tsv", tmp_path / "map.txt", expansion, 40, 15)
    assert n == jax_maxp.write_passage_files(docs, tmp_path / "jc.tsv", tmp_path / "jmap.txt",
                                             expansion, 40, 15)
    for a, b in (("c.tsv", "jc.tsv"), ("map.txt", "jmap.txt")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()

    # a passage run: every query ranks passages with float scores (ties too)
    with open(tmp_path / "run.tsv", "w", encoding="utf-8") as f:
        for q in ("2", "10", "1", "7"):
            pids = rng.choice(n, min(n, 60), replace=False)
            for rank, pid in enumerate(pids, start=1):
                f.write(f"{q}\t{pid}\t{rank}\t{float(rng.integers(1, 30)) / 4}\n")
        f.write("short line\n")
    for top_k in ("1000", "3"):
        args = ["--run_file", str(tmp_path / "run.tsv"), "--mapping", str(tmp_path / "map.txt"),
                "--top_k", top_k]
        assert aggregate_main(args + ["--output", str(tmp_path / "doc.run")]) == 0
        assert jax_aggregate_main(args + ["--output", str(tmp_path / "jdoc.run")]) == 0
        assert (tmp_path / "doc.run").read_bytes() == (tmp_path / "jdoc.run").read_bytes()
    capsys.readouterr()
