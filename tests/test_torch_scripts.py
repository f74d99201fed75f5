"""The port's data-prep scripts against the JAX package's, on the same
inputs: every output byte-equal (a gzip file's payload: the header holds
the write time), each ``main(argv)`` too.  The cases are those of
``tests/test_scripts.py`` (its two expansion cases come with the expansion
modules), then one ``main`` per module over a seeded corpus with
duplicate pids, expansions and stopwords."""

import gzip
import json
import pickle

import numpy as np
import pytest

import improving_learned_index_tpu.scripts as jax_scripts
import improving_learned_index_tpu_torch.scripts as port_scripts
from improving_learned_index_tpu.scripts import (
    construct_distil_hard_neg_dataset,
    construct_hard_neg_dataset,
    create_test_files,
    create_training_files,
    create_unique_passage_mapping,
    prepare_dataset,
    preprocess_passages,
    trim_scores,
)
from improving_learned_index_tpu_torch.scripts import (
    construct_distil_hard_neg_dataset as p_distil,
)
from improving_learned_index_tpu_torch.scripts import construct_hard_neg_dataset as p_hard_neg
from improving_learned_index_tpu_torch.scripts import create_passages as p_passages
from improving_learned_index_tpu_torch.scripts import create_test_files as p_test_files
from improving_learned_index_tpu_torch.scripts import create_training_files as p_training
from improving_learned_index_tpu_torch.scripts import create_training_files_maxp as p_maxp
from improving_learned_index_tpu_torch.scripts import create_unique_passage_mapping as p_dedup
from improving_learned_index_tpu_torch.scripts import prepare_dataset as p_prepare
from improving_learned_index_tpu_torch.scripts import preprocess_passages as p_preprocess
from improving_learned_index_tpu_torch.scripts import trim_scores as p_trim

MODULES = ["construct_distil_hard_neg_dataset", "construct_hard_neg_dataset", "create_passages",
           "create_test_files", "create_training_files", "create_training_files_maxp",
           "create_unique_passage_mapping", "prepare_dataset", "preprocess_passages", "trim_scores"]


def _payload(path):
    data = path.read_bytes()
    return gzip.decompress(data) if path.suffix == ".gz" else data


def _same_outputs(a_dir, b_dir):
    names = sorted(p.name for p in a_dir.iterdir())
    assert names == sorted(p.name for p in b_dir.iterdir())
    for name in names:
        assert _payload(a_dir / name) == _payload(b_dir / name), name
    return names


def _both(tmp_path, run):
    """``run(out_dir, package)`` once per package; the outputs must be equal."""
    outs = {}
    for name, pkg in (("jax", "jax"), ("port", "port")):
        d = tmp_path / name
        d.mkdir()
        outs[name] = run(d, pkg)
    assert outs["jax"] == outs["port"]
    _same_outputs(tmp_path / "jax", tmp_path / "port")
    return outs["port"]


def test_construct_hard_neg(tmp_path):
    src = tmp_path / "neg.jsonl.gz"
    with gzip.open(src, "wt") as f:
        f.write(json.dumps({"qid": "q1", "pos": ["p1"], "neg": {"bm25": ["n1", "n2"], "dense": ["n2", "n3"]}}) + "\n")
    fns = {"jax": construct_hard_neg_dataset.construct, "port": p_hard_neg.construct}
    n = _both(tmp_path, lambda d, pkg: fns[pkg](src, d / "triples.tsv", seed=0))
    assert n == 3
    rows = {tuple(l.split("\t")) for l in (tmp_path / "port" / "triples.tsv").read_text().splitlines()}
    assert rows == {("q1", "p1", "n1"), ("q1", "p1", "n2"), ("q1", "p1", "n3")}


def test_construct_distil_and_trim(tmp_path):
    qrels = tmp_path / "qrels.tsv"
    qrels.write_text("q1\t0\tp1\t1\n")
    scores_path = tmp_path / "scores.pkl.gz"
    coll = tmp_path / "coll.tsv"
    coll.write_text("p1\ttext one\nn2\ttext two\n")

    def run(d, pkg):
        with gzip.open(scores_path, "wb") as f:
            pickle.dump({"q1": {"p1": 9.0, "n1": 3.0, "n2": 1.0}}, f)
        distil = {"jax": construct_distil_hard_neg_dataset.construct, "port": p_distil.construct}[pkg]
        n = distil(qrels, scores_path, d / "distil.tsv", seed=0)
        with gzip.open(scores_path, "wb") as f:
            pickle.dump({"q1": {"p1": 9.0, "n1": 3.0, "n2": 1.0}}, f)
        kept = {"jax": trim_scores.trim, "port": p_trim.trim}[pkg](scores_path, coll, d / "trimmed.pkl.gz")
        return n, kept

    assert _both(tmp_path, run) == (2, 2)
    rows = {tuple(l.split("\t")) for l in (tmp_path / "port" / "distil.tsv").read_text().splitlines()}
    assert ("q1", "p1", "n1", "9.0", "3.0") in rows
    with gzip.open(tmp_path / "port" / "trimmed.pkl.gz", "rb") as f:
        assert pickle.load(f) == {"q1": {"p1": 9.0, "n2": 1.0}}


def test_prepare_dataset(tmp_path):
    (tmp_path / "qrels.tsv").write_text("q1\t0\td1\t1\n")
    (tmp_path / "queries.tsv").write_text("q1\twhat is a fox\n")
    (tmp_path / "coll.tsv").write_text("d1\tfoxes are canines\n")
    fns = {"jax": prepare_dataset.prepare, "port": p_prepare.prepare}
    n = _both(tmp_path, lambda d, pkg: fns[pkg](tmp_path / "qrels.tsv", tmp_path / "queries.tsv",
                                                tmp_path / "coll.tsv", d / "pairs.tsv"))
    assert n == 1
    assert (tmp_path / "port" / "pairs.tsv").read_text() == "foxes are canines\twhat is a fox\n"


@pytest.mark.parametrize("case", ["expand", "budget"])
def test_expand_training_files(tmp_path, case):
    if case == "expand":
        (tmp_path / "docs.tsv").write_text("d1\tthe quick fox\nd2\tlazy dog\n")
        queries = ["quick animal", "animal colour", "fox animal"]
        kw = dict(max_length=20, max_expansion_terms=2)
    else:
        (tmp_path / "docs.tsv").write_text("d1\t" + " ".join(f"w{i}" for i in range(30)) + "\n")
        queries = ["novel1 novel2"]
        kw = dict(max_length=10)
    exp = tmp_path / "exp.jsonl"
    exp.write_text(json.dumps({"doc_id": "d1", "queries": queries}) + "\n")
    fns = {"jax": create_training_files.expand_training_files, "port": p_training.expand_training_files}
    n = _both(tmp_path, lambda d, pkg: fns[pkg](tmp_path / "docs.tsv", exp, d / "expanded.tsv",
                                                d / "terms.csv", **kw))
    assert n == 1
    line = (tmp_path / "port" / "expanded.tsv").read_text().strip()
    if case == "expand":
        # 'animal' (freq 3) first, then 'colour'; 'quick'/'fox' deduped
        assert line == "d1\tthe quick fox animal colour"
    else:
        words = line.split("\t")[1].split()
        assert len(words) == 10 and words[-2:] == ["novel1", "novel2"]


def test_dedup_passages(tmp_path):
    (tmp_path / "c.tsv").write_text("p1\ta\np2\tb\np1\tc\n")
    fns = {"jax": create_unique_passage_mapping.dedup, "port": p_dedup.dedup}
    assert _both(tmp_path, lambda d, pkg: fns[pkg](tmp_path / "c.tsv", d / "out.tsv")) == (2, 1)
    assert (tmp_path / "port" / "out.tsv").read_text() == "p1\ta\np2\tb\n"


def test_preprocess_resume(tmp_path):
    (tmp_path / "c.tsv").write_text("p1\tThe Quick FOX\np2\tnot a lazy dog\n")
    stop = tmp_path / "stop.txt"
    stop.write_text("the\nnot\na\n")
    fns = {"jax": preprocess_passages.preprocess_collection, "port": p_preprocess.preprocess_collection}

    def run(d, pkg):
        first = fns[pkg](tmp_path / "c.tsv", d / "pre.tsv", stop)
        return first, fns[pkg](tmp_path / "c.tsv", d / "pre.tsv", stop)  # resume: nothing new

    assert _both(tmp_path, run) == (2, 0)
    # 'not' kept (negation whitelist)
    assert (tmp_path / "port" / "pre.tsv").read_text().splitlines() == ["p1\tquick fox", "p2\tnot lazy dog"]


def test_create_test_files(tmp_path):
    (tmp_path / "qmap.csv").write_text("query_id,query\nq1,claim one\nq2,claim two\n")
    (tmp_path / "pairs.csv").write_text("query,document\nclaim one,evidence text\nclaim two,lost text\n")
    (tmp_path / "dmap.csv").write_text("doc_id,document\nd7,evidence text\n")
    fns = {"jax": create_test_files.create_test_files, "port": p_test_files.create_test_files}
    counts = _both(tmp_path, lambda d, pkg: fns[pkg](
        tmp_path / "qmap.csv", tmp_path / "pairs.csv", tmp_path / "dmap.csv",
        d / "queries.tsv", d / "qrels.tsv"))
    assert counts == (2, 1, 1)
    assert (tmp_path / "port" / "qrels.tsv").read_text() == "q1\t0\td7\t1\n"


# -- each main(argv), over one seeded data set -----------------------------------


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A seeded corpus (with duplicate pids), queries, qrels, mined
    negatives, teacher scores, expansions, stopwords and the CSVs of
    ``create_test_files``."""
    d = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(40)] + ["not", "the", "a", "Fox", "dog"]
    docs = [" ".join(rng.choice(words, int(rng.integers(5, 30)))) for _ in range(24)]
    pids = [str(i) for i in range(24)] + ["3", "7"]
    texts = docs + ["dup three", "dup seven"]
    (d / "coll.tsv").write_text("".join(f"{p}\t{t}\n" for p, t in zip(pids, texts)))
    (d / "queries.tsv").write_text("".join(f"q{i}\t{' '.join(rng.choice(words, 3))}\n" for i in range(6)))
    (d / "qrels.tsv").write_text("".join(f"q{i}\t0\t{2 * i}\t1\n" for i in range(6)))
    with gzip.open(d / "neg.jsonl.gz", "wt") as f:
        for i in range(6):
            negs = {"bm25": [str(x) for x in rng.choice(24, 4, replace=False)],
                    "dense": [str(x) for x in rng.choice(24, 3, replace=False)]}
            f.write(json.dumps({"qid": f"q{i}", "pos": [str(2 * i)], "neg": negs}) + "\n")
    scores = {f"q{i}": {str(p): float(rng.integers(0, 100)) / 4 for p in {2 * i, *rng.choice(30, 5)}}
              for i in range(6)}
    with gzip.open(d / "scores.pkl.gz", "wb") as f:
        pickle.dump(scores, f)
    (d / "exp.jsonl").write_text("".join(
        json.dumps({"doc_id": str(i), "queries": [" ".join(rng.choice(words, 3)) for _ in range(3)]}) + "\n"
        for i in range(0, 24, 2)))
    (d / "stop.txt").write_text("the\na\nnot\nw1\n")
    (d / "qmap.csv").write_text("query_id,query\n" + "".join(f"q{i},claim {i}\n" for i in range(4)))
    (d / "pairs.csv").write_text("query,document\n" + "".join(f"claim {i},{docs[i]}\n" for i in range(4)))
    (d / "dmap.csv").write_text("doc_id,document\n" + "".join(f"{i},{docs[i]}\n" for i in range(3)))
    return d


def _argv(module, i, o):
    """``main``'s arguments for ``module`` over inputs ``i`` into ``o``."""
    return {
        "construct_distil_hard_neg_dataset": ["--qrels_path", i / "qrels.tsv", "--scores_path",
                                              i / "scores.pkl.gz", "--output_path", o / "distil.tsv",
                                              "--seed", "3"],
        "construct_hard_neg_dataset": ["--negatives_path", i / "neg.jsonl.gz", "--output_path",
                                       o / "triples.tsv", "--seed", "1"],
        "create_passages": ["--collection_path", i / "coll.tsv", "--output_collection", o / "passages.tsv",
                            "--output_mapping", o / "pid_mapping.txt", "--expansions_path", i / "exp.jsonl",
                            "--window", "8", "--stride", "5"],
        "create_test_files": ["--query_mapping", i / "qmap.csv", "--pairs_file", i / "pairs.csv",
                              "--doc_mapping", i / "dmap.csv", "--output_queries", o / "queries.tsv",
                              "--output_qrels", o / "qrels.tsv"],
        "create_training_files": ["--doc_mapping", i / "coll.tsv", "--expansions_path", i / "exp.jsonl",
                                  "--output_docs_tsv", o / "docs.tsv", "--output_expansion_csv",
                                  o / "terms.csv", "--max_length", "16", "--max_expansion_terms", "4"],
        "create_training_files_maxp": ["--passage_mapping", i / "coll.tsv", "--expansions_path",
                                       i / "exp.jsonl", "--output_docs_tsv", o / "docs.tsv",
                                       "--output_expansion_csv", o / "terms.csv", "--max_length", "12"],
        "create_unique_passage_mapping": ["--collection_path", i / "coll.tsv", "--output_path", o / "uniq.tsv"],
        "prepare_dataset": ["--qrels_path", i / "qrels.tsv", "--queries_path", i / "queries.tsv",
                            "--collection_path", i / "coll.tsv", "--output_path", o / "pairs.tsv"],
        "preprocess_passages": ["--collection_path", i / "coll.tsv", "--output_path", o / "pre.tsv",
                                "--stopwords_path", i / "stop.txt"],
        "trim_scores": ["--scores_path", i / "scores.pkl.gz", "--collection_path", i / "coll.tsv",
                        "--output_path", o / "trimmed.pkl.gz"],
    }[module]


@pytest.mark.parametrize("module", MODULES)
def test_main_matches_jax(tmp_path, inputs, module, capsys):
    import importlib

    printed = {}
    for name, pkg in (("jax", jax_scripts), ("port", port_scripts)):
        out = tmp_path / name
        out.mkdir()
        main = importlib.import_module(f"{pkg.__name__}.{module}").main
        assert main([str(a) for a in _argv(module, inputs, out)]) == 0
        printed[name] = capsys.readouterr().out.replace(str(out), "OUT")
    assert printed["jax"] == printed["port"]
    names = _same_outputs(tmp_path / "jax", tmp_path / "port")
    assert names and all((tmp_path / "port" / n).stat().st_size > 0 for n in names)


def test_every_module_ported():
    import pkgutil

    jax_mods = sorted(m.name for m in pkgutil.iter_modules(jax_scripts.__path__))
    assert jax_mods == sorted(m.name for m in pkgutil.iter_modules(port_scripts.__path__)) == MODULES
    for m in (p_distil, p_hard_neg, p_passages, p_test_files, p_training, p_maxp, p_dedup, p_prepare,
              p_preprocess, p_trim):
        assert callable(m.main)
