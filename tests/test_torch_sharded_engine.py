"""Port's ``ShardedSearchEngine`` on ``["cpu"] * 8`` (the kernels' plain
versions) against the JAX ``ShardedSearchEngine`` on the suite's 8 virtual
CPU devices, and against the port's single ``HybridSearchEngine``: the same
ranked (doc, score) lists rank by rank, boundary ties in doc-id order, and
the same doc ranges and heavy rows.  The JAX engines are built and queried
once, in a module-scoped fixture."""

from types import SimpleNamespace

import numpy as np
import pytest

from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.search.sharded_engine import ShardedSearchEngine as JaxSharded
from improving_learned_index_tpu_torch.index.inverted import index_from_numpy
from improving_learned_index_tpu_torch.parallel.multidevice import sparse_tile_index
from improving_learned_index_tpu_torch.search import ShardedSearchEngine
from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine

CPU8 = ["cpu"] * 8


def _random_index(rng, num_docs, vocab_size, postings):
    """Zipf-ish synthetic quantized index (as tests/test_sharded_engine.py)."""
    p = 1.0 / np.arange(1, vocab_size + 1)
    p /= p.sum()
    tids = rng.choice(vocab_size, size=postings, p=p)
    docs = rng.integers(0, num_docs, postings)
    vals = rng.integers(1, 256, postings)
    per_doc = {}
    for t, d, v in zip(tids, docs, vals):
        per_doc.setdefault(int(d), {})[f"t{t}"] = int(v)
    return JaxIndex.build(sorted(per_doc.items()), num_docs=num_docs)


def _tile_aligned_index():
    """The JAX dryrun's sparse geometry: 8 x 524,288 + 777 docs (shards of
    whole 65536-doc tiles), tile-boundary docs included, as the JAX type."""
    idx = sparse_tile_index(8 * 524288 + 777)
    return JaxIndex(list(idx.vocab), idx.offsets.copy(), idx.doc_ids.copy(), idx.impacts.copy(),
                    num_docs=idx.num_docs)


MIXED_QUERIES = [
    {"t0", "t1", "t7"},
    {f"t{i}" for i in range(25)},
    {"t3", "missing-term"},
    set(),
    {"t0"},
]
# name -> (index maker, heavy_min, batches, k)
CASES = {
    "mixed": (lambda: _random_index(np.random.default_rng(11), 700, 50, 7000), 48,
              [MIXED_QUERIES], 40),
    "all_tail": (lambda: _random_index(np.random.default_rng(11), 700, 50, 7000), 10**9,
                 [MIXED_QUERIES], 40),
    "k_above_shard_docs": (lambda: _random_index(np.random.default_rng(2), 200, 20, 2000), 64,
                           [[{"t0", "t1", "t2"}, {"t5"}]], 300),
    "all_docs_in_shard_0": (lambda: _random_index(np.random.default_rng(3), 10, 6, 40), 4,
                            [[{"t0", "t1"}, {"t2", "t5"}, {"t4"}]], 7),
    "all_docs_in_shard_0_all_tail": (lambda: _random_index(np.random.default_rng(3), 10, 6, 40), 10**9,
                                     [[{"t0", "t1"}, {"t2", "t5"}, {"t4"}]], 7),
    "unknown_terms_only": (lambda: _random_index(np.random.default_rng(4), 300, 25, 3000), 48,
                           [[{"nosuch"}, set(), {"other", "missing"}]], 15),
    "tile_aligned_all_tail": (_tile_aligned_index, 10**9,
                              [[{f"t{i}" for i in range(8)}, {"t0"}, {"nosuch"}]], 50),
}


def _port_index(jidx):
    return index_from_numpy(jidx.vocab, jidx.offsets, jidx.doc_ids, jidx.impacts, jidx.num_docs)


@pytest.fixture(scope="module")
def jax_runs(cpu_devices):
    """Each case's JAX engine geometry and answers, computed once."""
    import jax
    from jax.sharding import Mesh

    mesh = Mesh(np.asarray(jax.devices()[:8]), axis_names=("data",))
    out = {}
    for name, (make, heavy_min, batches, k) in CASES.items():
        jidx = make()
        eng = JaxSharded(jidx, mesh, heavy_min=heavy_min)
        out[name] = SimpleNamespace(
            index=jidx, shard_docs=eng.shard_docs, doc_lo=np.asarray(eng.doc_lo),
            heavy_row_arr=eng.heavy_row_arr.copy(),
            answers=[eng.score_batch(b, k) for b in batches],
        )
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_equals_jax_sharded_and_hybrid(jax_runs, name):
    _, heavy_min, batches, k = CASES[name]
    run = jax_runs[name]
    idx = _port_index(run.index)
    eng = ShardedSearchEngine(idx, CPU8, heavy_min=heavy_min)
    assert eng.n_shards == 8
    assert eng.shard_docs == run.shard_docs
    assert np.array_equal(eng.doc_lo, run.doc_lo)
    assert np.array_equal(eng.heavy_row_arr, run.heavy_row_arr)
    for shard in eng.shards:
        assert np.array_equal(shard.heavy_row_arr, run.heavy_row_arr)
        assert shard.n_pad == eng.shard_docs
    single = HybridSearchEngine(idx, heavy_min=heavy_min, device="cpu")
    for batch, want in zip(batches, run.answers):
        got = eng.score_batch(batch, k)
        assert got == want
        assert got == single.score_batch(batch, k)


def test_every_doc_in_shard_0_leaves_seven_empty_shards(jax_runs):
    idx = _port_index(jax_runs["all_docs_in_shard_0"].index)
    eng = ShardedSearchEngine(idx, CPU8, heavy_min=4)
    assert eng.shard_docs == 128 and eng.num_docs == 10
    assert [s.doc_ids.numel() for s in eng.shards[1:]] == [0] * 7
    assert all(not s.dense.any() for s in eng.shards[1:])
    got = eng.score_batch([{"t0", "t1"}], 7)[0]
    assert got and all(d < 10 for d, _ in got)


def test_tile_aligned_shards(jax_runs):
    run = jax_runs["tile_aligned_all_tail"]
    assert run.shard_docs % (1 << 16) == 0 and run.shard_docs >= 1 << 19
    eng = ShardedSearchEngine(_port_index(run.index), CPU8, heavy_min=10**9)
    assert eng.t_heavy == 0 and eng.shard_docs == run.shard_docs


def test_empty_batch_and_stream_depth_2(jax_runs):
    idx = _port_index(jax_runs["mixed"].index)
    eng = ShardedSearchEngine(idx, CPU8, heavy_min=48)
    assert eng.score_batch([], 10) == []
    batches = [MIXED_QUERIES, [{"t2", "t3"}], [], [{"t1", "t9"}, set()]] * 2
    want = [eng.score_batch(b, 40) for b in batches]
    assert list(eng.score_stream(batches, top_k=40, depth=2)) == want
    assert want[0] == jax_runs["mixed"].answers[0]


def test_shard_split_keeps_each_lists_order():
    """A shard's postings are its docs' postings in the index's term order,
    each list's order kept (impact-descending lists stay so)."""
    from improving_learned_index_tpu_torch.search.sharded_engine import _shard_postings

    offsets = np.array([0, 4, 4, 7, 8], np.int64)
    docs = np.array([9, 1, 5, 2, 3, 8, 0, 6], np.uint32)
    vals = np.array([9, 8, 7, 6, 9, 3, 1, 5], np.uint8)
    off, d, v = _shard_postings(offsets, np.diff(offsets), docs, vals, 4, 8)
    assert off.tolist() == [0, 1, 1, 1, 2]
    assert d.tolist() == [1, 2] and v.tolist() == [7, 5]
    off, d, v = _shard_postings(offsets, np.diff(offsets), docs, vals, 8, None)
    assert off.tolist() == [0, 1, 1, 2, 2] and d.tolist() == [1, 0] and v.tolist() == [9, 3]


def test_non_integer_impacts_raise():
    float_index = SimpleNamespace(term_to_id={"a": 0}, offsets=np.array([0, 2]),
                                  doc_ids=np.array([0, 1], np.uint32),
                                  impacts=np.array([0.5, 1.25], np.float32), num_docs=2)
    with pytest.raises(ValueError, match="integer"):
        ShardedSearchEngine(float_index, ["cpu"] * 2)


def test_released_engine_raises(jax_runs):
    eng = ShardedSearchEngine(_port_index(jax_runs["k_above_shard_docs"].index), ["cpu"] * 2,
                              heavy_min=64)
    eng.release()
    with pytest.raises(RuntimeError, match="released"):
        eng.score_batch([{"t0"}], 5)
