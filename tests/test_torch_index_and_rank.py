"""The port's index files, tokenizer, ranker CLI and run metrics against the
JAX package's: identical arrays, identical bytes, identical run files."""

import filecmp

import numpy as np
import pytest

from improving_learned_index_tpu.cli.rank import main as jax_rank_main
from improving_learned_index_tpu.evaluation.run_metrics import Metrics as JaxMetrics
from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu.utils.sorting import radix_argsort as jax_radix_argsort
from improving_learned_index_tpu_torch.cli.rank import main as rank_main
from improving_learned_index_tpu_torch.evaluation.run_metrics import Metrics
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData, index_from_numpy
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
from improving_learned_index_tpu_torch.utils.sorting import radix_argsort

FILES = ("vocab.txt", "inverted_index.idx", "inverted_index.dat")
ARRAYS = ("offsets", "doc_ids", "impacts", "zero_offsets", "zero_doc_ids")


def _jax_index(seed=0, num_docs=400, n_terms=50, with_zeros=True):
    rng = np.random.default_rng(seed)
    per_doc = []
    for d in range(num_docs):
        terms = rng.choice(n_terms, size=int(rng.integers(1, 12)), replace=False)
        vals = rng.integers(0 if with_zeros else 1, 256, len(terms))
        per_doc.append((d, {f"w{t}": int(v) for t, v in zip(terms, vals)}))
    return JaxIndex.build(per_doc, num_docs=num_docs)


def _assert_same_arrays(a, b):
    assert list(a.vocab) == list(b.vocab) and a.num_docs == b.num_docs
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_jax_saved_index_loads_identically(tmp_path):
    jidx = _jax_index()
    assert len(jidx.zero_doc_ids)  # the zero-impact side CSR is exercised
    jidx.save(tmp_path / "jax")
    ours = InvertedIndexData.load(tmp_path / "jax", num_docs=jidx.num_docs)
    _assert_same_arrays(ours, JaxIndex.load(tmp_path / "jax", num_docs=jidx.num_docs))
    assert ours.num_postings == jidx.num_postings
    for term in ("w3", "w17", "missing"):
        for x, y in zip(ours.term_postings(term), jidx.term_postings(term)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("with_zeros", [True, False])
def test_port_save_is_byte_identical(tmp_path, with_zeros):
    jidx = _jax_index(seed=1, with_zeros=with_zeros)
    jidx.save(tmp_path / "jax")
    index_from_numpy(
        jidx.vocab, jidx.offsets, jidx.doc_ids, jidx.impacts, jidx.num_docs,
        jidx.zero_offsets, jidx.zero_doc_ids,
    ).save(tmp_path / "port")
    InvertedIndexData.load(tmp_path / "jax").save(tmp_path / "port_roundtrip")
    for name in FILES:
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "port" / name, shallow=False)
        assert filecmp.cmp(
            tmp_path / "jax" / name, tmp_path / "port_roundtrip" / name, shallow=False
        )


def test_dedupe_sum_duplicates_matches_jax():
    rng = np.random.default_rng(2)
    vocab = [f"w{i}" for i in range(6)]
    lens = rng.integers(1, 40, 6)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    docs = rng.integers(0, 30, int(offsets[-1])).astype(np.uint32)  # many duplicates
    vals = rng.integers(1, 256, int(offsets[-1])).astype(np.uint8)
    jidx = JaxIndex(vocab, offsets, docs, vals, num_docs=30)
    ours = index_from_numpy(vocab, offsets, docs, vals, 30)
    jidx._dedupe_sum_duplicates(block=16)
    ours._dedupe_sum_duplicates(block=16)
    _assert_same_arrays(ours, jidx)


@pytest.mark.parametrize("hi", [200, 60_000, 1 << 40])
def test_radix_argsort_matches_jax(hi):
    key = np.random.default_rng(3).integers(0, hi, 5000, dtype=np.int64)
    assert np.array_equal(radix_argsort(key), jax_radix_argsort(key))


QUERY_TEXTS = [
    "w1 w2 w3",
    "W4, w5! (w6)",
    "w7\tw8\nw9",
    "Café naïve — “w10” déjà-vu w11",
    "東京 w12 Ünïcödé",
    "nothing known here",
    "",
    "w13 w13 w14 ... w15?",
]


def test_process_query_identical_term_sets(tiny_corpus):
    vocab = JaxVocab.build(tiny_corpus + QUERY_TEXTS, max_size=256)
    ours = ImpactTokenizer(WordPieceVocab(vocab.id_to_token))
    theirs = JaxTokenizer(vocab)
    for text in QUERY_TEXTS + tiny_corpus:
        assert ours.process_query(text) == theirs.process_query(text), text


def test_rank_cli_run_file_and_metrics_identical(tmp_path, tiny_corpus):
    jidx = _jax_index(seed=4, num_docs=600, n_terms=40, with_zeros=False)
    jidx.save(tmp_path / "index")
    JaxVocab.build(tiny_corpus + QUERY_TEXTS, max_size=256).save(tmp_path / "vocab.txt")
    rng = np.random.default_rng(5)
    queries = QUERY_TEXTS + [
        " ".join(f"w{t}" for t in rng.choice(40, size=int(rng.integers(1, 6)))) for _ in range(30)
    ]
    (tmp_path / "queries.tsv").write_text(
        "".join(f"q{i}\t{q.replace(chr(10), ' ')}\n" for i, q in enumerate(queries)),
        encoding="utf-8",
    )
    (tmp_path / "qrels.tsv").write_text(
        "".join(f"q{i}\t0\t{int(d)}\t1\n"
                for i, d in enumerate(rng.integers(0, 600, len(queries)))),
        encoding="utf-8",
    )
    common = [
        "--index_path", str(tmp_path / "index"),
        "--queries_path", str(tmp_path / "queries.tsv"),
        "--vocab_path", str(tmp_path / "vocab.txt"),
        "--top_k", "100",
    ]
    assert jax_rank_main(
        common + ["--output_path", str(tmp_path / "jax.run"), "--engine", "hybrid"]
    ) == 0
    assert rank_main(common + ["--output_path", str(tmp_path / "port.run"), "--device", "cpu"]) == 0
    assert (tmp_path / "port.run").read_bytes() == (tmp_path / "jax.run").read_bytes()
    assert len((tmp_path / "port.run").read_text().splitlines()) > 100

    qrels = tmp_path / "qrels.tsv"
    assert Metrics(tmp_path / "port.run", qrels).evaluate() == JaxMetrics(
        tmp_path / "jax.run", qrels
    ).evaluate()
