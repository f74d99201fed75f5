"""The port's in-memory eval against the JAX package's: TREC metrics, BM25,
the hybrid engine's float mode, ``SparseSearch`` on both sides of the
100,000-doc engine switch, and ``NanoBEIREvaluator``.

Tolerances.  Metrics, BM25 and sums of dyadic impacts (multiples of 2^-8,
at most a dozen a query) are exact in any order: equal, ties included.
Other float impacts are summed in another order by the port (the
``gather_rows`` plain version's ``w @ rows``, the scatter) than by XLA, so
their scores are held within 1e-5 relative (a few fp32 ulps of sums of at
most a dozen terms) and their doc order exactly (no two scores of those
fixtures lie that close).  ``SparseSearch`` with a model adds the fp32
encoder's difference (2e-5 a impact at S=32, as
``tests/test_torch_encoder.py`` holds it): scores within 3e-4, order equal
except between scores that close."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import improving_learned_index_tpu.ops.short_attention as jsa
from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.evaluation import bm25 as jax_bm25
from improving_learned_index_tpu.evaluation import nano_beir as jax_nano
from improving_learned_index_tpu.evaluation import sparse_search as jax_sparse
from improving_learned_index_tpu.evaluation import trec_metrics as jax_trec
from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
from improving_learned_index_tpu.search import device_engine as jax_device
from improving_learned_index_tpu.search import hybrid_engine as jax_hybrid
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.evaluation import (
    BM25Index,
    NanoBEIREvaluator,
    SparseSearch,
    load_local_beir_dir,
    trec_evaluate,
)
from improving_learned_index_tpu_torch.evaluation import nano_beir, sparse_search
from improving_learned_index_tpu_torch.models import DeepImpact, flax_params_to_port
from improving_learned_index_tpu_torch.search import hybrid_engine
from improving_learned_index_tpu_torch.search.device_engine import DeviceSearchEngine
from improving_learned_index_tpu_torch.search.hybrid_engine import (
    HybridSearchEngine,
    build_dense_rows,
)
from improving_learned_index_tpu_torch.search.select import HYBRID_MIN_DOCS
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
from test_nano_beir_full import ALL_13, UnitImpactModel, _write_beir_dir

REPO_PORT = "improving_learned_index_tpu_torch/evaluation"


def test_host_modules_are_the_jax_packages_copies():
    """trec_metrics and bm25 are numpy-only: the port carries them byte for
    byte."""
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    for name in ("trec_metrics.py", "bm25.py"):
        ours = (repo / REPO_PORT / name).read_bytes()
        assert ours == (repo / "improving_learned_index_tpu/evaluation" / name).read_bytes(), name


# -- TREC metrics ------------------------------------------------------------------


def _runs_with_ties(seed, n_queries=12, n_docs=60):
    """Seeded runs whose scores come from a few values (many ties, broken
    by trec_eval's doc-id-descending order), graded qrels (0-3, some
    queries without a relevant doc, one qrel-less run, one run-less
    query)."""
    rng = np.random.default_rng(seed)
    qrels, results = {}, {}
    for q in range(n_queries):
        qid = f"q{q}"
        docs = rng.choice(n_docs, int(rng.integers(1, 40)), replace=False)
        results[qid] = {f"d{d}": float(rng.integers(0, 6)) / 2 for d in docs}
        rel = rng.choice(n_docs, int(rng.integers(0, 8)), replace=False)
        qrels[qid] = {f"d{d}": int(rng.integers(0, 4)) for d in rel}
    qrels["q_no_run"] = {"d1": 2}
    results["q_no_qrels"] = {"d1": 1.0}
    return qrels, results


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k_values", [(10, 100, 1000), (1, 3, 5), (2,)])
def test_trec_evaluate_equals_jax(seed, k_values):
    qrels, results = _runs_with_ties(seed)
    got = trec_evaluate(qrels, results, k_values)
    assert got == jax_trec.evaluate(qrels, results, k_values)
    assert [list(d) for d in got] == [[f"{m}@{k}" for k in k_values]
                                       for m in ("NDCG", "MAP", "Recall", "P")]


def test_trec_tie_order_is_doc_id_descending():
    """Two docs tie at the top; trec_eval ranks the larger doc id first."""
    qrels = {"q": {"a": 1}}
    ndcg = trec_evaluate(qrels, {"q": {"a": 2.0, "b": 2.0}}, (1,))[0]["NDCG@1"]
    assert ndcg == 0.0  # "b" ranks first
    assert trec_evaluate(qrels, {"q": {"a": 2.0, "b": 1.0}}, (1,))[0]["NDCG@1"] == 1.0
    assert trec_evaluate({}, {}, (10,)) == jax_trec.evaluate({}, {}, (10,))


# -- BM25 ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bm25_corpus(tiny_corpus):
    rng = np.random.default_rng(3)
    words = " ".join(tiny_corpus).split()
    docs = [(f"p{i}", " ".join(rng.choice(words, int(rng.integers(3, 15)))))
            for i in range(80)]
    return docs, tiny_corpus


@pytest.mark.parametrize("k1,b", [(1.2, 0.75), (0.9, 0.4)])
def test_bm25_equals_jax(bm25_corpus, k1, b):
    docs, vocab_corpus = bm25_corpus
    ours_tok = ImpactTokenizer(WordPieceVocab.build(vocab_corpus, max_size=512), max_length=32)
    theirs_tok = JaxTokenizer(JaxVocab.build(vocab_corpus, max_size=512), max_length=32)
    ours = BM25Index(k1=k1, b=b).build(docs, ours_tok)
    theirs = jax_bm25.BM25Index(k1=k1, b=b).build(docs, theirs_tok)
    assert ours.doc_lens == theirs.doc_lens and ours.postings == theirs.postings
    queries = {f"q{i}": " ".join(docs[i * 7][1].split()[:3]) for i in range(10)}
    queries["none"] = "zzzz unknown"
    for top_k in (1, 5, 1000):
        assert ours.search(queries, ours_tok, top_k) == theirs.search(queries, theirs_tok, top_k)
    for q in queries.values():
        terms = ours_tok.process_query(q)
        assert ours.score(terms, 10) == theirs.score(terms, 10)


# -- the hybrid engine's float mode ----------------------------------------------------


def _float_docs(rng, n_docs=400, vocab=40, per_doc=6):
    return [[(f"w{t}", float(rng.random() * 3 - 0.3)) for t in rng.choice(vocab, per_doc, replace=False)]
            for _ in range(n_docs)]


def _dyadic_docs(rng, n_docs=400, vocab=30):
    """Impacts k / 256, k in 1..8 (a few zeros and negatives dropped by the
    build): every sum of a dozen is exact in fp32, and ties are many."""
    return [[(f"w{t}", float(rng.integers(-1, 9)) / 256)
             for t in rng.choice(vocab, int(rng.integers(1, 13)), replace=False)]
            for _ in range(n_docs)]


def _queries(rng, vocab, n=16, most=12):
    qs = [{f"w{i}" for i in rng.choice(vocab, int(rng.integers(1, most + 1)), replace=False)}
          for _ in range(n)]
    return qs + [set(), {"unknown"}, {"w0", "unknown"}]


def _close_rankings(got, want, rel=1e-5):
    """Same docs in the same order (no two scores of these fixtures lie
    within the tolerance), scores within ``rel``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [d for d, _ in g] == [d for d, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=rel)


@pytest.mark.parametrize("heavy_min,budget", [
    (1, 4 << 30),     # every term a dense row
    (30, 4 << 30),    # the longer lists dense, the rest tail
    (1, 2 * 512 * 7),  # a 7-row budget at 2 bytes a cell: the longest 7 lists
    (10**9, 4 << 30),  # tail only
])
def test_hybrid_float_equals_jax_and_device_engine(heavy_min, budget):
    docs = _float_docs(np.random.default_rng(5))
    qs = _queries(np.random.default_rng(6), 40, most=6)
    ours = HybridSearchEngine.from_term_impacts(docs, heavy_min=heavy_min, dense_budget_bytes=budget,
                                                device="cpu")
    theirs = jax_hybrid.HybridSearchEngine.from_term_impacts(docs, heavy_min=heavy_min,
                                                             dense_budget_bytes=budget)
    device = DeviceSearchEngine.from_term_impacts(docs, device="cpu")
    assert not ours.integer_scores and not device.integer_scores
    assert ours.n_pad == theirs.n_pad and ours.t_heavy == theirs.t_heavy
    np.testing.assert_array_equal(ours.heavy_row_arr, theirs.heavy_row_arr)  # same heavy rows
    if budget < 4 << 30:
        assert ours.t_heavy == 7
    if ours.t_heavy:
        assert ours.dense.dtype == torch.float32
    assert ours.impacts.dtype == torch.float32
    for k in (1, 5, 1000):
        want = theirs.score_batch(qs, k)
        _close_rankings(ours.score_batch(qs, k), want)
        _close_rankings(device.score_batch(qs, k), want)


@pytest.mark.parametrize("heavy_min", [1, 40, 10**9])
def test_hybrid_float_dyadic_is_exact(heavy_min):
    """Sums of dyadic impacts are exact in any order: every engine returns
    the same (doc, score) lists, ties in doc-id order included."""
    docs = _dyadic_docs(np.random.default_rng(7))
    qs = _queries(np.random.default_rng(8), 30)
    ours = HybridSearchEngine.from_term_impacts(docs, heavy_min=heavy_min, device="cpu")
    theirs = jax_hybrid.HybridSearchEngine.from_term_impacts(docs, heavy_min=heavy_min)
    np.testing.assert_array_equal(ours.heavy_row_arr, theirs.heavy_row_arr)
    device = DeviceSearchEngine.from_term_impacts(docs, device="cpu")
    jax_dev = jax_device.DeviceSearchEngine.from_term_impacts(docs)
    ties = 0
    for k in (1, 7, 1000):
        want = theirs.score_batch(qs, k)
        assert ours.score_batch(qs, k) == want
        assert device.score_batch(qs, k) == want
        assert jax_dev.score_batch(qs, k) == want
        ties += sum(len(r) - len({s for _, s in r}) for r in want)
    assert ties > 50  # the fixture does test the tie order


def test_hybrid_float_keeps_fp32_and_never_takes_the_integer_top_k(monkeypatch):
    """Impacts 0.75 + 0.5 must score 1.25, not a uint8-truncated 0, and the
    float top-k is a sort: the n-ary threshold search is never called."""
    def refuse(*a, **k):
        raise AssertionError("exact_topk_integer on float scores")

    monkeypatch.setattr(hybrid_engine, "exact_topk_integer", refuse)
    docs = [[("a", 0.75), ("b", 0.5)], [("a", 1.25)], [("b", 1.25)], [("a", 0.0), ("c", -1.0)]]
    for heavy_min in (1, 10**9):
        eng = HybridSearchEngine.from_term_impacts(docs, heavy_min=heavy_min, device="cpu")
        assert eng.dense.dtype == torch.float32 and eng.impacts.dtype == torch.float32
        assert eng.score_batch([{"a", "b"}, {"c"}], 10) == [[(0, 1.25), (1, 1.25), (2, 1.25)], []]
        assert eng.score_batch([{"a"}], 1) == [[(1, 1.25)]]
        assert "c" not in eng.vocab  # non-positive impacts are not kept


def test_build_dense_rows_force_fp32():
    """fp32 rows from the start, even where every cell would fit bf16."""
    docs = torch.tensor([0, 2, 2, 1], dtype=torch.int32)
    vals = torch.tensor([0.1, 0.2, 0.3, 1.0])
    starts = np.array([0, 3, 4])
    got = build_dense_rows(docs, vals, starts, 2, 4, force_fp32=True)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.tensor([[0.1, 0.0, 0.5, 0.0], [0.0, 1.0, 0.0, 0.0]]),
                               rtol=0, atol=0)
    assert build_dense_rows(docs, vals.round(), starts, 2, 4).dtype == torch.bfloat16
    assert build_dense_rows(docs[:0], vals[:0], np.array([0, 0]), 1, 4, force_fp32=True).dtype == torch.float32


# -- SparseSearch ------------------------------------------------------------------


@pytest.fixture(scope="module")
def eval_models(tiny_tokenizer, tiny_corpus):
    """(JAX model, port model): a tiny fp32 softplus model (every impact
    positive, so both keep the same terms), flax init carried across."""
    jc = dataclasses.replace(JaxConfig.tiny(vocab_size=len(tiny_tokenizer.vocab),
                                            impact_activation="softplus"), dtype="float32")
    jm = JaxDeepImpact(jc, tiny_tokenizer, seed=0)
    tok = ImpactTokenizer(WordPieceVocab.build(tiny_corpus, max_size=512), max_length=32)
    tc = dataclasses.replace(EncoderConfig.tiny(vocab_size=len(tok.vocab), impact_activation="softplus"),
                             dtype="float32")
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jm.params), tc)
    return jm, DeepImpact(tc, tok, state_dict=sd, device="cpu")


@pytest.fixture(scope="module")
def eval_data(tiny_corpus):
    rng = np.random.default_rng(11)
    words = " ".join(tiny_corpus).split()
    corpus = {f"d{i}": " ".join(rng.choice(words, int(rng.integers(3, 12)))) for i in range(70)}
    queries = {f"q{i}": " ".join(rng.choice(words, int(rng.integers(1, 4)), replace=False))
               for i in range(20)}
    return queries, corpus


def _near_rankings(got, want, atol):
    """Scores within ``atol`` rank by rank; where the doc ids differ, both
    docs' scores lie within 2 * ``atol`` (an encoder near-tie)."""
    assert got.keys() == want.keys()
    for qid in want:
        g = sorted(got[qid].items(), key=lambda x: (-x[1], x[0]))
        w = sorted(want[qid].items(), key=lambda x: (-x[1], x[0]))
        assert len(g) == len(w), qid
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=0, atol=atol)
        for (gd, gs), (wd, ws) in zip(g, w):
            if gd != wd:
                assert abs(got[qid][wd] - gs) <= 2 * atol, (qid, gd, wd)


@pytest.mark.parametrize("side", ["device", "hybrid"])
def test_sparse_search_equals_jax_on_both_sides_of_the_switch(monkeypatch, eval_models, eval_data, side):
    jm, pm = eval_models
    monkeypatch.setattr(jsa, "interpret", True)
    switch = 10 if side == "hybrid" else 10**6
    monkeypatch.setattr(sparse_search, "HYBRID_MIN_DOCS", switch)
    monkeypatch.setattr(jax_sparse, "HYBRID_MIN_DOCS", switch)
    queries, corpus = eval_data
    ours, theirs = SparseSearch(pm, batch_size=16), jax_sparse.SparseSearch(jm, batch_size=16)
    got = ours.search(queries, corpus, k=1000)
    want = theirs.search(queries, corpus, k=1000)
    want_cls = HybridSearchEngine if side == "hybrid" else DeviceSearchEngine
    assert type(ours.engine) is want_cls and type(theirs.engine).__name__ == want_cls.__name__
    assert ours.engine.device == torch.device("cpu")  # the model's device
    assert len(ours.engine.vocab) == len(theirs.engine.vocab)
    _near_rankings(got, want, atol=3e-4)
    assert sum(map(len, got.values())) > 200
    # unpacked encode: the same term lists, scores within the same tolerance
    _near_rankings(SparseSearch(pm, batch_size=16, use_packing=False).search(queries, corpus), want, 3e-4)


class _StubImpacts(UnitImpactModel):
    """Dyadic impacts from a word's length: exact sums, no encoder."""

    def get_impact_scores_batch(self, texts):
        return [[(t, len(t) / 8) for t in dict.fromkeys(text.lower().split())] for text in texts]


@pytest.mark.parametrize("n_docs,engine", [(HYBRID_MIN_DOCS - 1, DeviceSearchEngine),
                                           (HYBRID_MIN_DOCS, HybridSearchEngine)])
def test_sparse_search_at_the_real_switch(n_docs, engine):
    assert HYBRID_MIN_DOCS == jax_sparse.HYBRID_MIN_DOCS == 100_000
    rng = np.random.default_rng(13)
    words = np.array([f"w{i}" for i in range(300)] + ["rare"])
    picks = rng.integers(0, 300, (n_docs, 2))
    corpus = {str(i): f"{words[a]} {words[b]}" for i, (a, b) in enumerate(picks)}
    corpus[str(n_docs - 1)] = "rare w1"
    queries = {"a": "w1 w2", "b": "rare", "c": "w299 w7 w13", "d": "nothing"}
    model = _StubImpacts()
    ours = SparseSearch(model, batch_size=4096, device="cpu")
    theirs = jax_sparse.SparseSearch(model, batch_size=4096)
    got = ours.search(queries, corpus, k=1000)
    want = theirs.search(queries, corpus, k=1000)
    assert type(ours.engine) is engine and type(theirs.engine).__name__ == engine.__name__
    assert got == want
    assert list(got["b"]) == [str(n_docs - 1)] and got["d"] == {}


def test_sparse_search_device_rule():
    """The engines' device is the caller's, else the model's; a model
    without one means cuda, which raises without a card."""
    assert SparseSearch(UnitImpactModel(), device="cpu").device == "cpu"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        SparseSearch(UnitImpactModel(), device="cpu", use_kernels=True).search({"q": "a"}, {"d": "a"})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SparseSearch(UnitImpactModel()).search({"q": "a"}, {"d": "a"})
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HybridSearchEngine.from_term_impacts([[("a", 1.0)]])


# -- NanoBEIR ------------------------------------------------------------------------


class _CpuUnitModel(UnitImpactModel):
    """The unit-impact stub on the CPU: the evaluator's engines take the
    model's device."""

    device = "cpu"


@pytest.fixture(scope="module")
def nano_13(tmp_path_factory):
    root = tmp_path_factory.mktemp("nano13_port")
    for name in ALL_13:
        _write_beir_dir(root, name, perfect=(name != "scifact"))
    return root


def test_evaluate_all_13_equals_jax(nano_13):
    ours = NanoBEIREvaluator(batch_size=8, local_data_dir=nano_13)
    theirs = jax_nano.NanoBEIREvaluator(batch_size=8, local_data_dir=nano_13)
    assert ours.datasets == theirs.datasets == ALL_13
    got = ours.evaluate_all(_CpuUnitModel())
    assert got == theirs.evaluate_all(UnitImpactModel())
    assert got["scifact"][0]["NDCG@10"] == round(1 / np.log2(3), 5)
    assert json.loads(json.dumps(got))["avg"][1]["MAP@10"] == round((12 + 0.5) / 13, 5)


def test_evaluator_listing_and_loader_equal_jax(nano_13, tmp_path, monkeypatch):
    """The hermetic listing, the environment default, a subset, the loader's
    qrels fallbacks and the empty-directory refusal, as the JAX package has
    them."""
    monkeypatch.setenv("ILI_TPU_NANO_BEIR_DIR", str(nano_13))
    assert NanoBEIREvaluator().datasets == jax_nano.NanoBEIREvaluator().datasets == ALL_13
    sub = NanoBEIREvaluator(datasets=["nq", "scifact"])
    assert sub.evaluate_all(_CpuUnitModel()) == jax_nano.NanoBEIREvaluator(
        datasets=["nq", "scifact"]).evaluate_all(UnitImpactModel())
    monkeypatch.delenv("ILI_TPU_NANO_BEIR_DIR")
    assert nano_beir.DATASET_NAME_TO_ID == jax_nano.DATASET_NAME_TO_ID
    assert nano_beir.DATASET_NAME_TO_HUMAN == jax_nano.DATASET_NAME_TO_HUMAN
    # qrels/test.tsv without a header, a graded relevance, an empty text
    d = tmp_path / "alt"
    (d / "qrels").mkdir(parents=True)
    (d / "corpus.jsonl").write_text(
        "".join(json.dumps(x) + "\n" for x in ({"_id": 1, "title": "t", "text": "x y"},
                                               {"_id": "2", "text": ""})))
    (d / "queries.jsonl").write_text(json.dumps({"_id": "q", "text": "x"}) + "\n"
                                     + json.dumps({"_id": "e", "text": ""}) + "\n")
    (d / "qrels" / "test.tsv").write_text("q\t1\t2\nq\t2\n")
    got, want = load_local_beir_dir(d), jax_nano.load_local_beir_dir(d)
    assert (got.corpus, got.queries, got.relevant_docs, got.name) == (
        want.corpus, want.queries, want.relevant_docs, want.name)
    assert got.corpus == {"1": "t x y"} and got.relevant_docs == {"q": {"1": 2, "2": 1}}
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="no BEIR-format datasets"):
        NanoBEIREvaluator(local_data_dir=tmp_path / "empty")
