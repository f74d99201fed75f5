"""Port's ``PallasBlockedEngine`` (device="cpu": the blocked kernel's and
the tail scatter's plain versions) against the JAX package's, run with
``approx_top_k=False, interpret=True``: the same device arrays, the same
chunk tables array for array (including the zero-width chunks of empty
unaligned blocks), and the same ranked lists rank by rank.  Integer impacts:
every comparison is exact."""

import numpy as np
import pytest
import torch

from improving_learned_index_tpu.index import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.ops.pallas_scoring import PallasBlockedEngine as JaxBlocked
from improving_learned_index_tpu.search import InvertedIndex as JaxHost
from improving_learned_index_tpu_torch.index.inverted import index_from_numpy
from improving_learned_index_tpu_torch.ops import pallas_scoring as ps
from improving_learned_index_tpu_torch.ops.pallas_scoring import BLK, HEAVY_MIN, PallasBlockedEngine


def _mixed_index(rng, num_docs=9000, heavy_terms=3, tail_terms=27):
    """As tests/test_pallas_scoring.py: 3 heavy lists, 27 tail lists,
    postings impact-descending within each term."""
    tids, docs, vals = [], [], []
    for t in range(heavy_terms + tail_terms):
        n = HEAVY_MIN + 2000 if t < heavy_terms else 300
        d = rng.choice(num_docs, size=n, replace=False)
        tids.append(np.full(len(d), t))
        docs.append(d)
        vals.append(rng.integers(1, 255, len(d)))
    tid, doc, val = np.concatenate(tids), np.concatenate(docs), np.concatenate(vals)
    order = np.lexsort((-val, tid))
    nterms = heavy_terms + tail_terms
    offsets = np.zeros(nterms + 1, np.int64)
    np.cumsum(np.bincount(tid, minlength=nterms), out=offsets[1:])
    return JaxIndex([f"t{t}" for t in range(nterms)], offsets, doc[order].astype(np.uint32),
                    val[order].astype(np.uint8), num_docs=num_docs)


def _edge_index():
    """The block-boundary fixture of tests/test_pallas_scoring.py: one heavy
    term covering the block edges plus filler."""
    num_docs = 2 * BLK + 5
    edge_docs = [0, BLK - 1, BLK, 2 * BLK - 1, 2 * BLK, num_docs - 1]
    filler = np.random.default_rng(1).choice(num_docs, size=HEAVY_MIN, replace=False)
    all_docs = np.unique(np.concatenate([filler, np.asarray(edge_docs)]))
    return JaxIndex.build(((int(d), {"heavy": 7}) for d in all_docs), num_docs=num_docs), edge_docs


def _gap_index():
    """Heavy terms with empty blocks: "gap" has 3000 postings in block 0,
    none in blocks 1-2 (their start, 3000, is not 128-aligned: zero-width
    chunks) and 2000 in block 3; "aligned" empties blocks after exactly 4096
    postings (aligned start: no chunk); plus a tail term."""
    rng = np.random.default_rng(9)
    num_docs = 5 * BLK
    gap = np.concatenate([rng.choice(BLK, 3000, replace=False),
                          3 * BLK + rng.choice(BLK, 2000, replace=False)])
    aligned = np.concatenate([np.arange(BLK), 4 * BLK + rng.choice(BLK, 100, replace=False)])
    tail = rng.choice(num_docs, 50, replace=False)
    per_doc = {}
    for name, docs in (("gap", gap), ("aligned", aligned), ("tail", tail)):
        for d, v in zip(docs, rng.integers(1, 256, len(docs))):
            per_doc.setdefault(int(d), {})[name] = int(v)
    return JaxIndex.build(sorted(per_doc.items()), num_docs=num_docs)


def _port(jidx):
    idx = index_from_numpy(jidx.vocab, jidx.offsets, jidx.doc_ids, jidx.impacts, jidx.num_docs)
    return PallasBlockedEngine(idx, device="cpu")


QUERIES = {
    "mixed": [{"t0", "t5"}, {"t1", "t2", "t20"}, {"t7"}, {"t0"}, {"unknown"}, set(),
              {"t0", "t1", "t2"}, {"t2", "t9", "t11"}, {"t1", "t3", "t4"}],
    "edge": [{"heavy"}, set(), {"heavy", "none"}],
    "gap": [{"gap"}, {"aligned", "tail"}, {"gap", "aligned"}, {"tail"}, set(), {"gap", "tail"}],
}


def _index(name):
    if name == "mixed":
        return _mixed_index(np.random.default_rng(0))
    if name == "edge":
        return _edge_index()[0]
    return _gap_index()


@pytest.mark.parametrize("name", ["mixed", "edge", "gap"])
def test_tables_equal_jax(name):
    jidx = _index(name)
    jeng, eng = JaxBlocked(jidx, approx_top_k=False, interpret=True), _port(jidx)
    np.testing.assert_array_equal(eng.docs.numpy(), np.asarray(jeng.docs))
    np.testing.assert_array_equal(eng.vals.numpy(), np.asarray(jeng.vals))
    assert eng.num_blocks == jeng.num_blocks
    qs = QUERIES[name]
    padded = list(qs) + [set()] * (-len(qs) % ps.QG)
    got, want = eng._tables(padded), jeng._tables(padded)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if name == "gap":  # the empty unaligned blocks keep their zero-width chunks
        meta = got[2]
        assert ((meta >> 14) & 0x3FFF == meta & 0x3FFF).sum() >= 2


@pytest.mark.parametrize("name", ["mixed", "edge", "gap"])
def test_score_batch_equals_jax_rank_by_rank(name):
    jidx = _index(name)
    jeng, eng = JaxBlocked(jidx, approx_top_k=False, interpret=True), _port(jidx)
    qs = QUERIES[name]
    for k in (jidx.num_docs, 10):
        want = jeng.score_batch(qs, k)
        got = eng.score_batch(qs, k)
        assert got == want
    # and the host engine's scores (the JAX test's check)
    host = JaxHost(jidx).score_batch(qs, jidx.num_docs)
    assert [dict(r) for r in eng.score_batch(qs, jidx.num_docs)] == [dict(r) for r in host]


def test_block_edge_docs_score():
    jidx, edge_docs = _edge_index()
    got = dict(_port(jidx).score_batch([{"heavy"}], jidx.num_docs)[0])
    for d in edge_docs:
        assert got.get(d) == 7.0


def test_plain_scores_equal_numpy():
    """The blocked plain version on one batch's tables equals a numpy
    scatter of the heavy postings (the cells' tiles, tail excluded)."""
    jidx = _mixed_index(np.random.default_rng(0))
    eng = _port(jidx)
    qs = QUERIES["mixed"] + [set()] * (-len(QUERIES["mixed"]) % ps.QG)
    cell_offsets, starts, meta, _ = eng._tables(qs)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    got = ps.blocked_scores(put(cell_offsets), put(starts), put(meta), eng.docs, eng.vals,
                            len(qs), eng.num_blocks)
    want = np.zeros((len(qs), eng.num_blocks * BLK), np.float32)
    for q, terms in enumerate(qs):
        for t in terms:
            tid = jidx.term_to_id.get(t)
            if tid is None or jidx.offsets[tid + 1] - jidx.offsets[tid] < HEAVY_MIN:
                continue
            s, e = jidx.offsets[tid], jidx.offsets[tid + 1]
            np.add.at(want[q], jidx.doc_ids[s:e].astype(np.int64), jidx.impacts[s:e].astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), want)


def test_device_rules():
    jidx = _mixed_index(np.random.default_rng(0))
    idx = index_from_numpy(jidx.vocab, jidx.offsets, jidx.doc_ids, jidx.impacts, jidx.num_docs)
    with pytest.raises(ValueError, match="approximate"):
        PallasBlockedEngine(idx, approx_top_k=True, device="cpu")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        PallasBlockedEngine(idx, device="cpu", use_kernels=True)
    eng = PallasBlockedEngine(idx, device="cpu")
    eng.release()
    with pytest.raises(RuntimeError, match="released"):
        eng.score_batch([{"t0"}])
