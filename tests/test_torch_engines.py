"""The port's other query engines against the JAX package's: host
(``InvertedIndex``), device (``DeviceSearchEngine``, device="cpu"), dense
(``DenseSearchEngine``, device="cpu"), native (C++, the port's own copy and
build), engine selection, and a seeded cross-engine fuzz over the random
worlds of tests/test_engine_fuzz.py in which every engine of the port
returns the JAX host engine's ranked lists rank by rank (score desc, doc id
asc: the tie order is exact).

Quantized impacts give integer sums, compared exactly.  Float impacts
(``from_term_impacts``) are summed in another order by the port's scatter
and row sums than by XLA, so their scores are held within 1e-5 relative
(a few fp32 ulps of sums of at most a dozen terms) and their doc order
exactly (no two scores of the fixture lie that close)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.search import dense_engine as jax_dense
from improving_learned_index_tpu.search import device_engine as jax_device
from improving_learned_index_tpu.search import select as jax_select
from improving_learned_index_tpu.search.engine import InvertedIndex as JaxHost
from improving_learned_index_tpu_torch.core.config import SearchConfig
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData, index_from_numpy
from improving_learned_index_tpu_torch.ops.pallas_scoring import PallasBlockedEngine
from improving_learned_index_tpu_torch.search import device_engine, native, select
from improving_learned_index_tpu_torch.search.dense_engine import DenseSearchEngine, host_topk
from improving_learned_index_tpu_torch.search.device_engine import DeviceSearchEngine
from improving_learned_index_tpu_torch.search.engine import InvertedIndex
from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
from improving_learned_index_tpu_torch.search.native import NativeSearchEngine
from test_engine_fuzz import _random_world

REPO = Path(__file__).resolve().parent.parent


def _port_index(j):
    return index_from_numpy(list(j.vocab), j.offsets, j.doc_ids, j.impacts, j.num_docs)


def _random_index(rng, num_docs=600, vocab_size=50, postings=5000):
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    per_doc = {}
    for t, d, v in zip(rng.choice(vocab_size, postings, p=p), rng.integers(0, num_docs, postings),
                       rng.integers(1, 256, postings)):
        per_doc.setdefault(int(d), {})[f"t{t}"] = int(v)
    return JaxIndex.build(sorted(per_doc.items()), num_docs=num_docs)


def _queries(rng, vocab, n=12):
    qs = [{vocab[i] for i in rng.integers(0, len(vocab), int(rng.integers(1, 6)))} for _ in range(n)]
    return qs + [set(), {"unknown"}, {vocab[0], "unknown"}]


def _float_docs(rng, n_docs=300, vocab=40):
    return [[(f"w{t}", float(rng.random() * 3 - 0.3)) for t in rng.choice(vocab, 6, replace=False)]
            for _ in range(n_docs)]


def test_native_source_is_byte_equal():
    ours = REPO / "improving_learned_index_tpu_torch" / "native" / "impact_engine.cpp"
    theirs = REPO / "improving_learned_index_tpu" / "native" / "impact_engine.cpp"
    assert ours.read_bytes() == theirs.read_bytes()
    assert native.library_path().parent == REPO / "build" / "native"


def test_host_engine_equals_jax():
    jidx = _random_index(np.random.default_rng(1))
    # a zero impact stops ``score`` (the reference's read loop) but not
    # ``score_batch``
    jidx.impacts[jidx.offsets[3] + 2] = 0
    ours, theirs = InvertedIndex(_port_index(jidx)), JaxHost(jidx)
    qs = _queries(np.random.default_rng(2), jidx.vocab)
    for k in (1, 10, 1000):
        assert ours.score_batch(qs, k) == theirs.score_batch(qs, k)
        for q in qs:
            assert ours.score(q, k) == theirs.score(q, k)
    t = jidx.vocab[3]
    assert ours.term_docs(t) == theirs.term_docs(t)


@pytest.mark.parametrize("k", [1, 7, 1000])
def test_device_engine_equals_jax(k):
    jidx = _random_index(np.random.default_rng(3))
    ours, theirs = DeviceSearchEngine(_port_index(jidx), device="cpu"), jax_device.DeviceSearchEngine(jidx)
    assert ours.integer_scores and ours.chunk == theirs.chunk
    for n in (1, 16, 17, 1000):
        assert device_engine._bucket(n) == jax_device._bucket(n)
    qs = _queries(np.random.default_rng(4), jidx.vocab)
    for g, w in zip(ours._chunk_table(qs), theirs._chunk_table(qs)):
        np.testing.assert_array_equal(g, w)
    assert ours.score_batch(qs, k) == theirs.score_batch(qs, k)


def test_device_engine_slices_long_batches(monkeypatch):
    """The gather runs a slice of the chunk table at a time: one chunk a
    slice gives the same ranking."""
    jidx = _random_index(np.random.default_rng(3))
    eng = DeviceSearchEngine(_port_index(jidx), device="cpu")
    qs = _queries(np.random.default_rng(4), jidx.vocab)
    want = eng.score_batch(qs, 50)
    monkeypatch.setattr(device_engine, "_MAX_UPDATES", 1)
    assert eng.score_batch(qs, 50) == want


def _close_rankings(got, want, rel=1e-5):
    """Same docs in the same order (no two scores of these fixtures lie
    within the tolerance), scores within ``rel``."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [d for d, _ in g] == [d for d, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w], rtol=rel)


def test_float_engines_equal_jax_within_tolerance():
    docs = _float_docs(np.random.default_rng(5))
    qs = [{f"w{i}" for i in np.random.default_rng(6).choice(40, 4, replace=False)} for _ in range(10)]
    qs.append(set())
    for ours, theirs in (
        (DeviceSearchEngine.from_term_impacts(docs, device="cpu"),
         jax_device.DeviceSearchEngine.from_term_impacts(docs)),
        (DenseSearchEngine.from_term_impacts(docs, device="cpu"),
         jax_dense.DenseSearchEngine.from_term_impacts(docs)),
    ):
        if isinstance(ours, DeviceSearchEngine):
            assert not ours.integer_scores
        else:
            assert ours.impact_matrix.dtype == torch.float32
        for k in (5, 1000):
            _close_rankings(ours.score_batch(qs, k), theirs.score_batch(qs, k))


@pytest.mark.parametrize("k", [1, 10, 1000])
def test_dense_engine_equals_jax(k):
    jidx = _random_index(np.random.default_rng(7))
    ours, theirs = DenseSearchEngine(_port_index(jidx), device="cpu"), jax_dense.DenseSearchEngine(jidx)
    assert ours.impact_matrix.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.impact_matrix.float().numpy(),
                                  np.asarray(theirs.impact_matrix, dtype=np.float32))
    qs = _queries(np.random.default_rng(8), jidx.vocab)
    got, jax_dense_rows = ours.score_batch(qs, k), theirs.score_batch(qs, k)
    # rank by rank as the JAX host engine; the JAX dense engine's scores and
    # its order above the k-th score (its boundary ties follow argpartition)
    assert got == JaxHost(jidx).score_batch(qs, k)
    for g, w in zip(got, jax_dense_rows):
        assert len(g) == len(w) and [s for _, s in g] == [s for _, s in w]
        if w:
            kth = w[-1][1]
            assert [x for x in g if x[1] > kth] == [x for x in w if x[1] > kth]
    assert DenseSearchEngine.fits(50, 600) == jax_dense.DenseSearchEngine.fits(50, 600)
    assert DenseSearchEngine.fits(10**5, 10**5) == jax_dense.DenseSearchEngine.fits(10**5, 10**5)
    tie_free = np.random.default_rng(9).random((3, 40)).astype(np.float32)
    tie_free[:, ::3] = 0
    for kk in (7, 40):
        assert host_topk(tie_free, kk) == jax_dense.host_topk(tie_free, kk)
    ties = np.random.default_rng(9).integers(0, 4, (3, 40)).astype(np.float32)
    order = np.lexsort((np.broadcast_to(np.arange(40), ties.shape), -ties))[:, :7]
    assert host_topk(ties, 7) == [
        [(int(d), float(row[d])) for d in o if row[d] > 0] for row, o in zip(ties, order)
    ]


def test_native_engine_equals_jax_host(tmp_path):
    jidx = _random_index(np.random.default_rng(10))
    jidx.save(tmp_path / "idx")
    eng = NativeSearchEngine(tmp_path / "idx")
    assert eng.num_terms == len(jidx.vocab)
    qs = _queries(np.random.default_rng(11), jidx.vocab)
    for k in (1, 10, 1000):
        assert eng.score_batch(qs, k) == JaxHost(jidx).score_batch(qs, k)
    eng.close()


def test_choose_and_build_engine_match_jax(tmp_path):
    assert (select.HYBRID_MIN_DOCS_QUANTIZED, select.HYBRID_MIN_DOCS) == (
        jax_select.HYBRID_MIN_DOCS_QUANTIZED, jax_select.HYBRID_MIN_DOCS)
    for n in (1, 3_999, 4_000, 99_999, 100_000, 10**7):
        for integer in (True, False):
            assert select.choose_engine(n, integer) == jax_select.choose_engine(n, integer)
    jidx = _random_index(np.random.default_rng(12))
    jidx.save(tmp_path / "idx")
    kinds = {"auto": DeviceSearchEngine, "device": DeviceSearchEngine, "hybrid": HybridSearchEngine,
             "host": InvertedIndex, "native": NativeSearchEngine}
    qs = _queries(np.random.default_rng(13), jidx.vocab)
    want = jax_select.build_engine(tmp_path / "idx", engine="host").score_batch(qs, 100)
    for name, cls in kinds.items():
        eng = select.build_engine(tmp_path / "idx", engine=name, device="cpu")
        assert type(eng) is cls
        assert eng.score_batch(qs, 100) == want
    with pytest.raises(ValueError, match="approximate"):
        select.build_engine(tmp_path / "idx", engine="host", approx_top_k=True)
    with pytest.raises(ValueError, match="unknown engine"):
        select.build_engine(tmp_path / "idx", engine="sharded")
    with pytest.raises(ValueError, match="approximate"):
        DeviceSearchEngine(_port_index(jidx), SearchConfig(approx_top_k=True), device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_engines_agree_on_random_worlds(seed, tmp_path):
    """Every engine of the port, on the worlds and queries of
    tests/test_engine_fuzz.py, returns the JAX host engine's ranked lists
    rank by rank."""
    rng = np.random.default_rng(100 + seed)
    world = _random_world(rng)
    heavy_min = int(rng.choice([1, 4, 64, 1024]))
    terms = world.vocab
    queries = []
    for _ in range(7):
        qn = int(rng.integers(1, 6))
        q = {terms[i] for i in rng.integers(0, len(terms), qn)}
        if rng.random() < 0.3:
            q.add("unknown_term")
        queries.append(q)
    queries.append(set())
    k = int(rng.choice([1, 3, 10, 1000]))
    want = JaxHost(world).score_batch(queries, k)

    idx = InvertedIndexData(world.vocab, world.offsets, world.doc_ids, world.impacts,
                            num_docs=world.num_docs)
    idx.save(tmp_path / "idx")
    engines = {
        "host": InvertedIndex(idx),
        "device": DeviceSearchEngine(idx, device="cpu"),
        "hybrid": HybridSearchEngine(idx, heavy_min=heavy_min, device="cpu"),
        "blocked": PallasBlockedEngine(idx, device="cpu"),
        "dense": DenseSearchEngine(idx, device="cpu"),
        "native": NativeSearchEngine(tmp_path / "idx"),
    }
    for name, eng in engines.items():
        assert eng.score_batch(queries, k) == want, (seed, name)
