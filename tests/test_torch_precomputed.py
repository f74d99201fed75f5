"""The port's precomputed-expansion tools (doc2query-- score filtering,
TILDE terms, ``cli.expand_precomputed``) against the JAX package on the CPU.

Host code on both sides: the same numpy-seeded collection and stores go
through the JAX functions and the port's.  Where the output's order is
defined (``append="queries"``, ``tilde_expand``, every document part) the
files are compared byte for byte; the novel terms that ``append="terms"``
adds come from a set (``get_unique_query_terms``), whose order follows the
process's string hashes, so that suffix is compared as a multiset of terms.
"""

import json

import numpy as np
import pytest

from improving_learned_index_tpu.cli import expand_precomputed as jcli
from improving_learned_index_tpu.expand import precomputed as jpre
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu_torch.cli import expand_precomputed as tcli
from improving_learned_index_tpu_torch.expand import precomputed as tpre
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

WORDS = [f"w{i}" for i in range(60)] + ["quick", "brown", "fox", "river", "sea", "impact"]
NOVEL = [f"novel{i}" for i in range(20)]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 40-passage collection (one blank line), a scored store in both JSONL
    shapes, a vocabulary and both packages' tokenizers over it."""
    d = tmp_path_factory.mktemp("precomputed")
    rng = np.random.default_rng(0)
    docs = {str(i): " ".join(rng.choice(WORDS, int(rng.integers(4, 12)))) for i in range(40)}
    lines = [f"{i}\t{t}\n" for i, t in docs.items()]
    lines.insert(7, "\n")
    (d / "c.tsv").write_text("".join(lines))
    rows = []
    for i in list(docs)[:36]:  # the last 4 passages have no entry
        n = int(rng.integers(0, 8))
        qs = [" ".join(rng.choice(WORDS + NOVEL, int(rng.integers(2, 5)))) for _ in range(n)]
        scores = np.round(rng.random(n), 4).tolist()
        if int(i) % 2:
            rows.append({"doc_id": i, "queries": [{"query": q, "score": s} for q, s in zip(qs, scores)]})
        elif int(i) % 3:
            rows.append({"doc_id": int(i), "queries": qs, "scores": scores})
        else:  # no scores: all 0.0
            rows.append({"doc_id": i, "queries": qs})
    (d / "store.jsonl").write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    WordPieceVocab.build(list(docs.values()) + NOVEL, max_size=400, min_freq=1).save(d / "vocab.txt")
    return dict(dir=d, docs=docs, tok=ImpactTokenizer(WordPieceVocab.load(d / "vocab.txt"), 128),
                jtok=JaxTokenizer(JaxVocab.load(d / "vocab.txt"), 128))


def split_terms(line):
    """(doc id, document part, sorted terms after `` [SEP] ``)."""
    doc_id, text = line.split("\t", 1)
    doc, _, suffix = text.partition(" [SEP] ")
    return doc_id, doc, sorted(suffix.split())


def same_up_to_term_order(got: str, want: str) -> None:
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert split_terms(a) == split_terms(b)


def test_load_scored_queries_jsonl_both_shapes(data):
    got = tpre.load_scored_queries_jsonl(data["dir"] / "store.jsonl")
    want = jpre.load_scored_queries_jsonl(data["dir"] / "store.jsonl")
    assert got == want and len(got) == 36
    assert all(isinstance(k, str) for k in got)
    shapes = {type(v[0][1]) for v in got.values() if v}
    assert shapes == {float}
    assert any(v and all(s == 0.0 for _, s in v) for v in got.values())


def test_score_percentile_threshold(data):
    store = tpre.load_scored_queries_jsonl(data["dir"] / "store.jsonl")
    for p in (0.0, 30.0, 50.0, 70.0, 99.5, 100.0):
        assert tpre.score_percentile_threshold(store, p) == jpre.score_percentile_threshold(store, p)
    assert tpre.score_percentile_threshold({}, 30.0) == float("-inf") == jpre.score_percentile_threshold({}, 30.0)
    assert tpre.score_percentile_threshold({"a": []}, 30.0) == float("-inf")


@pytest.mark.parametrize("append", ["queries", "terms"])
@pytest.mark.parametrize("percentile", [0.0, 30.0, 80.0])
def test_expand_with_precomputed_equals_jax(data, tmp_path, append, percentile):
    store = tpre.load_scored_queries_jsonl(data["dir"] / "store.jsonl")
    coll = data["dir"] / "c.tsv"
    n = tpre.expand_with_precomputed(coll, store, tmp_path / "port.tsv", data["tok"], percentile=percentile,
                                     append=append)
    m = jpre.expand_with_precomputed(coll, store, tmp_path / "jax.tsv", data["jtok"], percentile=percentile,
                                     append=append)
    assert n == m == len(data["docs"])
    got, want = (tmp_path / "port.tsv").read_text(), (tmp_path / "jax.tsv").read_text()
    if append == "queries":
        assert got == want
    else:
        same_up_to_term_order(got, want)
    grown = sum(" [SEP] " in line for line in got.splitlines())
    assert 0 < grown < len(data["docs"])
    for line in got.splitlines():  # each document part is its passage, unchanged
        doc_id, text = line.split("\t", 1)
        assert text.split(" [SEP] ")[0] == data["docs"][doc_id]


def test_tilde_expand_equals_jax(data, tmp_path):
    store = tpre.load_scored_queries_jsonl(data["dir"] / "store.jsonl")
    terms = {doc_id: [w for q, _ in qs for w in q.split()] for doc_id, qs in store.items()}
    coll = data["dir"] / "c.tsv"
    assert tpre.tilde_expand(coll, terms, tmp_path / "port.tsv", data["tok"]) == len(data["docs"])
    jpre.tilde_expand(coll, terms, tmp_path / "jax.tsv", data["jtok"])
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


def test_beir_collection(data, tmp_path):
    coll = tmp_path / "corpus.jsonl"
    coll.write_text("".join(json.dumps({"_id": i, "title": "t", "text": t}) + "\n"
                            for i, t in list(data["docs"].items())[:10]))
    store = tpre.load_scored_queries_jsonl(data["dir"] / "store.jsonl")
    tpre.expand_with_precomputed(coll, store, tmp_path / "port.tsv", data["tok"], append="queries",
                                 collection_type="beir")
    jpre.expand_with_precomputed(coll, store, tmp_path / "jax.tsv", data["jtok"], append="queries",
                                 collection_type="beir")
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()


@pytest.mark.parametrize("flags", [
    ["--threshold", "0.5"],                        # a fraction: p50
    ["--threshold", "30"],                         # a percentile
    ["--threshold", "1"],                          # 1 is a fraction: p100
    ["--threshold", "70", "--append", "queries"],
    ["--style", "tilde"],
], ids=["fraction", "percentile", "one", "queries", "tilde"])
def test_cli_equals_jax(data, tmp_path, flags):
    d = data["dir"]
    common = ["--vocab_path", str(d / "vocab.txt"), "--collection_path", str(d / "c.tsv"),
              "--queries_path", str(d / "store.jsonl")]
    assert tcli.main(common + flags + ["--output_path", str(tmp_path / "port.tsv")]) == 0
    assert jcli.main(common + flags + ["--output_path", str(tmp_path / "jax.tsv")]) == 0
    got, want = (tmp_path / "port.tsv").read_text(), (tmp_path / "jax.tsv").read_text()
    if "terms" in flags or not {"--append", "--style"} & set(flags):
        same_up_to_term_order(got, want)
    else:
        assert got == want
    if flags == ["--threshold", "0.5"]:  # the fraction and its percentile write the same file
        assert tcli.main(common + ["--threshold", "50", "--output_path", str(tmp_path / "p50.tsv")]) == 0
        same_up_to_term_order((tmp_path / "p50.tsv").read_text(), got)


@pytest.mark.parametrize("threshold", ["150", "-3"])
def test_cli_refuses_thresholds_out_of_range(data, tmp_path, threshold):
    d = data["dir"]
    args = ["--vocab_path", str(d / "vocab.txt"), "--collection_path", str(d / "c.tsv"), "--queries_path",
            str(d / "store.jsonl"), "--output_path", str(tmp_path / "o.tsv"), "--threshold", threshold]
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit, match="threshold"):
            main(args)
    assert not (tmp_path / "o.tsv").exists()
