"""Port's ``HybridSearchEngine`` (device="cpu": the kernels' plain versions)
against the JAX engine, on its XLA path and on its Pallas path run through
the Pallas interpreter: the same ranked (doc, score) lists, rank by rank,
including the doc-id order of boundary ties."""

import numpy as np
import pytest
import torch

from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.search import hybrid_engine as jax_hybrid
from improving_learned_index_tpu.search.hybrid_engine import HybridSearchEngine as JaxEngine
from improving_learned_index_tpu_torch.index.inverted import index_from_numpy
from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine

TILE = 1 << 16


def _port(jidx, **kw):
    idx = index_from_numpy(jidx.vocab, jidx.offsets, jidx.doc_ids, jidx.impacts, jidx.num_docs)
    return HybridSearchEngine(idx, device="cpu", **kw)


def _random_index(rng, num_docs=500, vocab_size=60, postings=6000):
    """Zipf-ish synthetic quantized index (as tests/test_hybrid_engine.py)."""
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    tids = rng.choice(vocab_size, size=postings, p=p)
    docs = rng.integers(0, num_docs, postings)
    vals = rng.integers(1, 256, postings)
    per_doc = {}
    for t, d, v in zip(tids, docs, vals):
        per_doc.setdefault(int(d), {})[f"t{t}"] = int(v)
    return JaxIndex.build(sorted(per_doc.items()), num_docs=num_docs)


def _toy_corpus_index(num_docs=70_000, n_terms=40, seed=3):
    """Terms t0-t4 heavy (>= 1024 postings), the rest tail (as
    tests/test_pallas_engine_kernels.py)."""
    rng = np.random.default_rng(seed)
    offsets, doc_ids, impacts = [0], [], []
    for t in range(n_terms):
        n_post = int(rng.integers(1500, 2500)) if t < 5 else int(rng.integers(3, 200))
        docs = np.unique(rng.integers(0, num_docs, n_post))
        offsets.append(offsets[-1] + len(docs))
        doc_ids.append(docs)
        impacts.append(rng.integers(1, 256, len(docs)))
    idx = JaxIndex(
        [f"t{t}" for t in range(n_terms)],
        np.asarray(offsets, np.int64),
        np.concatenate(doc_ids).astype(np.uint32),
        np.concatenate(impacts).astype(np.uint8),
        num_docs=num_docs,
    )
    return idx, rng


def _toy_batch(idx, rng, n_random):
    terms = idx.vocab
    batch = [
        {terms[i] for i in rng.choice(len(terms), size=4, replace=False)}
        for _ in range(n_random)
    ]
    batch.append(set())  # empty query
    batch.append({"t0"})  # heavy-only
    batch.append({"t30"})  # tail-only
    batch.append({"t31", "zz"})  # tail + unknown term
    batch.append({"zz"})  # unknown only
    return batch


@pytest.mark.parametrize("heavy_min", [1, 64, 10**9])
def test_port_matches_jax_xla_path(heavy_min):
    """heavy_min=1: all dense; 10**9: all tail; 64: mixed."""
    jidx = _random_index(np.random.default_rng(7))
    jax_eng = JaxEngine(jidx, heavy_min=heavy_min)
    eng = _port(jidx, heavy_min=heavy_min)
    queries = [
        {"t0", "t1", "t5"},
        {"t2", "t40", "unknown-term"},
        {f"t{i}" for i in range(20)},
        set(),
        {"unknown-only"},
    ]
    for k in (1, 10, 50, 1000):
        assert eng.score_batch(queries, k) == jax_eng.score_batch(queries, k), k


@pytest.mark.parametrize("n_random", [6, 62])  # 11- and 67-query batches
def test_port_matches_jax_pallas_interpret_path(monkeypatch, n_random):
    """The JAX engine's Pallas dispatch (gather + tail kernels, 64-query
    sub-batches), interpreted on the CPU, against the port."""
    monkeypatch.setattr(jax_hybrid, "_PALLAS_MIN_DOCS", TILE)
    jidx, rng = _toy_corpus_index()
    jax_eng = JaxEngine(jidx, heavy_min=1024)
    assert jax_eng.n_pad % TILE == 0 and jax_eng.t_heavy == 5
    jax_eng._pallas = True
    jax_eng._pallas_interpret = True
    eng = _port(jidx, heavy_min=1024)
    assert eng.t_heavy == 5
    batch = _toy_batch(jidx, rng, n_random)
    assert eng.score_batch(batch, 50) == jax_eng.score_batch(batch, 50)


def test_port_matches_jax_67_query_batch_xla():
    jidx, rng = _toy_corpus_index(seed=5)
    batch = _toy_batch(jidx, rng, 62)
    assert len(batch) == 67
    assert _port(jidx).score_batch(batch, 100) == JaxEngine(jidx).score_batch(batch, 100)


def test_duplicate_postings_force_fp32_rows():
    """Duplicate (term, doc) postings summing past 256 are not bf16-exact:
    the dense build must switch to fp32 rows, as the JAX engine does."""
    vocab = ["a", "b"]
    offsets = np.array([0, 3, 5], dtype=np.int64)
    doc_ids = np.array([0, 0, 1, 0, 1], dtype=np.uint32)  # 'a' lists doc0 twice
    impacts = np.array([200, 200, 3, 2, 9], dtype=np.uint8)
    jidx = JaxIndex(vocab, offsets, doc_ids, impacts, num_docs=2)
    jax_eng = JaxEngine(jidx, heavy_min=1)
    eng = _port(jidx, heavy_min=1)
    assert eng.dense.dtype == torch.float32
    q = [{"a", "b"}, {"a"}]
    assert eng.score_batch(q, 2) == jax_eng.score_batch(q, 2) == [
        [(0, 402.0), (1, 12.0)], [(0, 400.0), (1, 3.0)],
    ]


def test_stage_inputs_stage_one_heavy_table():
    """The heavy stage's input is one int32 table, the host grouping of the
    batch's (query, dense row) pairs; scoring through it equals the JAX
    layout (ids, pairs, counts) that ``accumulate_rows`` takes."""
    from improving_learned_index_tpu_torch.ops import gather_rows as gr

    jidx, rng = _toy_corpus_index(seed=6)
    eng = _port(jidx)
    batch = _toy_batch(jidx, rng, 70)
    heavy, tail = eng.stage_inputs(batch)
    heavy_q, heavy_rows = eng._tables(batch)[:2]
    assert heavy.dtype == torch.int32 and heavy.dim() == 1 and tail is not None
    assert np.array_equal(heavy.numpy(), gr.group_pairs(heavy_q, heavy_rows, len(batch)))
    uniq, slot = np.unique(heavy_rows, return_inverse=True)
    jax_layout = (torch.from_numpy(uniq.astype(np.int32)),
                  torch.from_numpy(np.stack([heavy_q, slot.reshape(-1)], 1).astype(np.int32)),
                  torch.tensor([len(uniq), len(heavy_q)], dtype=torch.int32))
    assert torch.equal(gr.accumulate_grouped(eng.dense, heavy, len(batch)),
                       gr.accumulate_rows(eng.dense, *jax_layout, len(batch)))


def test_bf16_rows_when_sums_fit():
    jidx = _random_index(np.random.default_rng(2), num_docs=300, vocab_size=30, postings=3000)
    eng = _port(jidx, heavy_min=32)
    assert eng.t_heavy > 0 and eng.dense.dtype == torch.bfloat16


def test_score_stream_matches_score_batch():
    jidx = _random_index(np.random.default_rng(9), num_docs=300, vocab_size=30, postings=3000)
    jax_eng = JaxEngine(jidx, heavy_min=48)
    eng = _port(jidx, heavy_min=48)
    batches = [[{"t0", "t1"}, {"t2", "t3", "t4"}], [{"t5"}], [set(), {"t1", "t9"}]] * 2
    want = list(jax_eng.score_stream(batches, top_k=15, depth=2))
    assert list(eng.score_stream(batches, top_k=15, depth=2)) == want
    assert [eng.score_batch(b, 15) for b in batches] == want


def test_dense_budget_caps_rows_like_jax():
    jidx = _random_index(np.random.default_rng(1), num_docs=300, vocab_size=40, postings=4000)
    budget = 2 * 384 * 3  # three rows at n_pad 384
    jax_eng = JaxEngine(jidx, heavy_min=1, dense_budget_bytes=budget)
    eng = _port(jidx, heavy_min=1, dense_budget_bytes=budget)
    assert eng.t_heavy == jax_eng.t_heavy == 3
    assert np.array_equal(eng.heavy_row_arr, jax_eng.heavy_row_arr)
    q = [{f"t{i}" for i in range(12)}]
    assert eng.score_batch(q, 300) == jax_eng.score_batch(q, 300)


class _CSR:
    pass


def _random_world(rng):
    """Corpus shapes from single-doc to 20k docs (as tests/test_engine_fuzz.py)."""
    num_docs = int(rng.choice([1, 3, 50, 700, 4096, 20000]))
    n_terms = int(rng.integers(2, 40))
    offsets, doc_ids, impacts = [0], [], []
    for _ in range(n_terms):
        style = rng.random()
        if style < 0.3:
            n_post = int(rng.integers(1, max(2, num_docs)))
        elif style < 0.6:
            n_post = int(rng.integers(1, 8))
        else:
            n_post = int(rng.integers(1, min(200, max(2, num_docs))))
        docs = np.unique(rng.integers(0, num_docs, n_post))
        vals = rng.integers(1, 256, len(docs)).astype(np.uint8)
        srt = np.argsort(-vals.astype(np.int64), kind="stable")
        doc_ids.append(docs[srt].astype(np.uint32))
        impacts.append(vals[srt])
        offsets.append(offsets[-1] + len(docs))
    idx = _CSR()
    idx.vocab = [f"t{i}" for i in range(n_terms)]
    idx.term_to_id = {t: i for i, t in enumerate(idx.vocab)}
    idx.offsets = np.asarray(offsets, np.int64)
    idx.doc_ids = np.concatenate(doc_ids)
    idx.impacts = np.concatenate(impacts)
    idx.num_docs = num_docs
    return idx


@pytest.mark.parametrize("seed", range(6))
def test_port_matches_jax_on_random_worlds(seed):
    rng = np.random.default_rng(100 + seed)
    idx = _random_world(rng)
    heavy_min = int(rng.choice([1, 4, 64, 1024]))
    jax_eng = JaxEngine(idx, heavy_min=heavy_min)
    eng = _port(idx, heavy_min=heavy_min)
    queries = []
    for _ in range(7):
        q = {idx.vocab[i] for i in rng.integers(0, len(idx.vocab), int(rng.integers(1, 6)))}
        if rng.random() < 0.3:
            q.add("unknown_term")
        queries.append(q)
    queries.append(set())
    k = int(rng.choice([1, 3, 10, 1000]))
    assert eng.score_batch(queries, k) == jax_eng.score_batch(queries, k)


def test_warmup_release_and_device_rules():
    jidx = _random_index(np.random.default_rng(4), num_docs=300, vocab_size=30, postings=3000)
    eng = _port(jidx, heavy_min=48)
    assert eng.warmup(max_batch=4, top_k=10) == 1
    assert eng.use_kernels is False  # CPU tensors: plain versions
    eng.release()
    eng.release()
    with pytest.raises(RuntimeError):
        eng.score_batch([{"t0"}], 5)
    with pytest.raises(ValueError):
        _port(jidx, use_kernels=True)  # no kernels on the CPU
