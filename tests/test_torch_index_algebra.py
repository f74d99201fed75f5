"""The port's index algebra (``merge``, ``filter_docs``, ``delete_docs``,
``split_docs``, their CLIs, and the duplicate-posting sums) against the JAX
package's, on the CPU.

Mirrors ``tests/test_index_merge.py``, ``tests/test_index_filter.py``,
``tests/test_index_algebra_fuzz.py`` and the dedupe cases of
``tests/test_hot_swap.py``: the same seeded corpora go through both
packages, and the saved index files must be byte-equal to each other and to
a one-shot build over the equivalent corpus.
"""

import json
import random

import numpy as np
import pytest

from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData

INDEX_FILES = ("inverted_index.dat", "inverted_index.idx", "vocab.txt")
TERMS = ["apple", "banana", "cherry", "date", "elder", "fig", "grape"]


def _docs(n, seed, zero_in=()):
    rng = random.Random(seed)
    out = []
    for d in range(n):
        doc = {t: rng.randint(1, 255) for t in rng.sample(TERMS, rng.randint(0, 4))}
        if d in zero_in or d % 5 == 1:
            doc["rareterm" if d < 10 else "zed"] = rng.randint(0, 3)  # incl. zeros
        out.append(doc)
    return out


def _build(docs, cls=InvertedIndexData):
    return cls.build(enumerate(docs), num_docs=len(docs))


def _same_index(tmp_path, *indexes):
    """Save each index and require byte-equal files."""
    dirs = []
    for i, ix in enumerate(indexes):
        d = tmp_path / f"cmp{len(list(tmp_path.glob('cmp*')))}_{i}"
        ix.save(d)
        dirs.append(d)
    for d in dirs[1:]:
        for f in INDEX_FILES:
            assert (d / f).read_bytes() == (dirs[0] / f).read_bytes(), (d, f)


# -- merge (tests/test_index_merge.py) ----------------------------------------


def test_merge_equals_oneshot_and_jax(tmp_path):
    shards = [_docs(7, 0, zero_in={2}), _docs(5, 1), _docs(9, 2, zero_in={0, 8})]
    full = _build([d for s in shards for d in s])
    merged = InvertedIndexData.merge([_build(s) for s in shards])
    jmerged = JaxIndex.merge([_build(s, JaxIndex) for s in shards])
    assert merged.num_docs == full.num_docs == jmerged.num_docs
    _same_index(tmp_path, full, merged, jmerged)


def test_merge_disjoint_vocabs():
    a = _build([{"only_a": 3}, {"only_a": 9}])
    b = _build([{"only_b": 5}])
    m = InvertedIndexData.merge([a, b])
    assert m.vocab == ["only_a", "only_b"]
    docs, vals = m.term_postings("only_a")
    assert docs.tolist() == [1, 0] and vals.tolist() == [9, 3]
    docs, vals = m.term_postings("only_b")
    assert docs.tolist() == [2] and vals.tolist() == [5]


def test_merge_explicit_offsets(tmp_path):
    a, b = _build([{"x": 1}]), _build([{"x": 2}])
    m = InvertedIndexData.merge([a, b], doc_offsets=[0, 10])
    docs, vals = m.term_postings("x")
    assert docs.tolist() == [10, 0] and vals.tolist() == [2, 1]
    assert m.num_docs == 11
    jm = JaxIndex.merge([_build([{"x": 1}], JaxIndex), _build([{"x": 2}], JaxIndex)], doc_offsets=[0, 10])
    _same_index(tmp_path, m, jm)


def test_hybrid_engine_over_merged_index():
    """The port's hybrid engine (CPU) over a merged index scores like the
    engine over the one-shot build."""
    from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine

    shards = [_docs(20, 7), _docs(15, 8)]
    merged = InvertedIndexData.merge([_build(s) for s in shards])
    oneshot = _build([d for s in shards for d in s])
    ea = HybridSearchEngine(merged, heavy_min=4, device="cpu")
    eb = HybridSearchEngine(oneshot, heavy_min=4, device="cpu")
    qs = [{"apple", "fig"}, {"banana"}, {"cherry", "date", "elder"}]
    assert ea.score_batch(qs, 10) == eb.score_batch(qs, 10)


def test_merge_cli(tmp_path):
    from improving_learned_index_tpu.cli import merge_indexes as jax_merge
    from improving_learned_index_tpu_torch.cli import merge_indexes

    shards = [_docs(6, 3), _docs(4, 4)]
    _build([d for s in shards for d in s]).save(tmp_path / "full")
    for i, s in enumerate(shards):
        _build(s).save(tmp_path / f"shard{i}")
    args = ["-i", str(tmp_path / "shard0"), str(tmp_path / "shard1"),
            "--num_docs", str(len(shards[0])), str(len(shards[1]))]
    assert merge_indexes.main(args + ["-o", str(tmp_path / "merged")]) == 0
    assert jax_merge.main(args + ["-o", str(tmp_path / "jmerged")]) == 0
    for f in INDEX_FILES:
        assert (tmp_path / "merged" / f).read_bytes() == (tmp_path / "full" / f).read_bytes(), f
        assert (tmp_path / "merged" / f).read_bytes() == (tmp_path / "jmerged" / f).read_bytes(), f
    with pytest.raises(SystemExit):
        merge_indexes.main(args[:3] + ["--num_docs", "6", "-o", str(tmp_path / "bad")])


# -- filter and split (tests/test_index_filter.py) ----------------------------


def test_filter_equals_oneshot_and_jax(tmp_path):
    docs = _docs(30, 0)
    rng = random.Random(1)
    keep = np.array([rng.random() > 0.3 for _ in docs])
    full = _build(docs)
    filtered = full.filter_docs(keep)
    oneshot = _build([d for d, k in zip(docs, keep) if k])
    jfiltered = _build(docs, JaxIndex).filter_docs(keep)
    assert filtered.num_docs == oneshot.num_docs == jfiltered.num_docs == int(keep.sum())
    _same_index(tmp_path, oneshot, filtered, jfiltered)
    with pytest.raises(ValueError, match="mask shape"):
        full.filter_docs(keep[:-1])


def test_filter_drops_emptied_terms():
    full = _build([{"solo": 7}, {"both": 1}, {"both": 2}])
    out = full.delete_docs([0])
    assert "solo" not in out.term_to_id
    docs, vals = out.term_postings("both")
    assert docs.tolist() == [1, 0] and vals.tolist() == [2, 1]


def test_filter_keep_all_and_none():
    docs = _docs(8, 2)
    full = _build(docs)
    same = full.filter_docs(np.ones(len(docs), bool))
    assert same.vocab == full.vocab and same.num_postings == full.num_postings
    empty = full.filter_docs(np.zeros(len(docs), bool))
    assert empty.num_docs == 0 and empty.num_postings == 0 and empty.vocab == []


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_split_merge_roundtrip(tmp_path, n_shards):
    docs = _docs(23, 5)
    full = _build(docs)
    shards = full.split_docs(n_shards)
    jshards = _build(docs, JaxIndex).split_docs(n_shards)
    assert [s.num_docs for s in shards] == [s.num_docs for s in jshards]
    assert sum(s.num_docs for s in shards) == full.num_docs
    for s, js in zip(shards, jshards):
        _same_index(tmp_path, s, js)
    _same_index(tmp_path, full, InvertedIndexData.merge(shards))
    with pytest.raises(ValueError, match="n_shards"):
        full.split_docs(0)


def test_split_cli_manifest(tmp_path):
    from improving_learned_index_tpu.cli import split_index as jax_split
    from improving_learned_index_tpu_torch.cli import split_index

    docs = _docs(10, 6)
    _build(docs).save(tmp_path / "inv")
    args = ["-i", str(tmp_path / "inv"), "--n_shards", "3", "--num_docs", str(len(docs))]
    assert split_index.main(args + ["-o", str(tmp_path / "shards")]) == 0
    assert jax_split.main(args + ["-o", str(tmp_path / "jshards")]) == 0
    manifest = json.loads((tmp_path / "shards" / "shards.json").read_text())
    assert (tmp_path / "shards" / "shards.json").read_bytes() == (tmp_path / "jshards" / "shards.json").read_bytes()
    assert [set(m) for m in manifest] == [{"path", "num_docs", "doc_offset"}] * 3
    assert sum(m["num_docs"] for m in manifest) == len(docs)
    assert manifest[0]["doc_offset"] == 0
    assert manifest[2]["doc_offset"] == manifest[0]["num_docs"] + manifest[1]["num_docs"]
    for m in manifest:
        for f in INDEX_FILES:
            assert (tmp_path / "shards" / m["path"] / f).read_bytes() == \
                (tmp_path / "jshards" / m["path"] / f).read_bytes()
    loaded = [InvertedIndexData.load(tmp_path / "shards" / m["path"], num_docs=m["num_docs"])
              for m in manifest]
    _same_index(tmp_path, _build(docs), InvertedIndexData.merge(loaded))


def test_filter_cli(tmp_path):
    from improving_learned_index_tpu.cli import filter_index as jax_filter
    from improving_learned_index_tpu_torch.cli import filter_index

    docs = _docs(12, 3)
    _build(docs).save(tmp_path / "inv")
    (tmp_path / "rm.txt").write_text("1\n4\n9\n")
    args = ["-i", str(tmp_path / "inv"), "--delete_ids_path", str(tmp_path / "rm.txt"),
            "--num_docs", str(len(docs))]
    assert filter_index.main(args + ["-o", str(tmp_path / "out")]) == 0
    assert jax_filter.main(args + ["-o", str(tmp_path / "jout")]) == 0
    _build([d for i, d in enumerate(docs) if i not in (1, 4, 9)]).save(tmp_path / "ref")
    for f in INDEX_FILES:
        assert (tmp_path / "out" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f
        assert (tmp_path / "out" / f).read_bytes() == (tmp_path / "jout" / f).read_bytes(), f


# -- composition fuzz (tests/test_index_algebra_fuzz.py) ----------------------

FUZZ_TERMS = [f"t{i:03d}" for i in range(40)] + ["x|y", "##sub", ":"]


def _fuzz_docs(rng, n):
    return [{t: rng.randint(0, 255) for t in rng.sample(FUZZ_TERMS, rng.randint(0, 6))}
            for _ in range(n)]


def test_wide_vocab_takes_combined_key_path(tmp_path):
    """Vocabs past 65536 terms (uint32 term ids in the scatter keys): the
    port's build equals the JAX build, and a save/load round trip keeps the
    bytes."""
    V, D = 70_000, 2000

    def gen():
        for d in range(D):
            yield d, {f"t{(d * 37 + i) % V:05d}": (d + i) % 255 + 1 for i in range(40)}

    a = InvertedIndexData.build(gen(), num_docs=D)
    assert len(a.vocab) > (1 << 16)
    b = InvertedIndexData.load(_saved(a, tmp_path / "wide"), num_docs=D)
    _same_index(tmp_path, a, b, JaxIndex.build(gen(), num_docs=D))


def _saved(ix, path):
    ix.save(path)
    return path


@pytest.mark.parametrize("seed", range(8))
def test_algebra_composition(tmp_path, seed):
    """Shard builds -> merge -> deletes -> save/load, in both packages, equal
    a one-shot build over the kept corpus."""
    rng = random.Random(seed)
    shards = [_fuzz_docs(rng, rng.randint(0, 12)) for _ in range(rng.randint(1, 4))]
    corpus = [d for s in shards for d in s]
    idx = InvertedIndexData.merge([_build(s) for s in shards]) if corpus else _build([])
    jidx = JaxIndex.merge([_build(s, JaxIndex) for s in shards]) if corpus else _build([], JaxIndex)
    kept = list(range(len(corpus)))
    for _ in range(rng.randint(0, 2)):
        if not kept:
            break
        drop = rng.sample(range(len(kept)), rng.randint(0, min(3, len(kept))))
        mask = np.ones(len(kept), bool)
        mask[drop] = False
        idx, jidx = idx.filter_docs(mask), jidx.filter_docs(mask)
        kept = [d for i, d in enumerate(kept) if mask[i]]
    if rng.random() < 0.5:
        idx = InvertedIndexData.load(_saved(idx, tmp_path / f"rt{seed}"), num_docs=len(kept))
    _same_index(tmp_path, _build([corpus[d] for d in kept]), idx, jidx)


# -- duplicate postings (the dedupe cases of tests/test_hot_swap.py) ----------


def test_build_dedupes_repeated_doc_id():
    idx = InvertedIndexData.build([(0, {"a": 3, "b": 1}), (1, {"a": 7}), (0, {"a": 4})])
    docs, vals = idx.term_postings("a")
    assert docs.tolist() == [0, 1] and vals.tolist() == [7, 7]
    docs, vals = idx.term_postings("b")
    assert docs.tolist() == [0] and vals.tolist() == [1]


def test_build_dedupe_saturates_at_255():
    idx = InvertedIndexData.build([(0, {"a": 200}), (0, {"a": 200})])
    docs, vals = idx.term_postings("a")
    assert docs.tolist() == [0] and vals.tolist() == [255]


def test_build_without_duplicates_unchanged(tmp_path):
    stream = [(i, {"a": i + 1, "b": 255 - i}) for i in range(50)]
    idx = InvertedIndexData.build(stream)
    idx2 = InvertedIndexData.build(stream)
    idx2._dedupe_sum_duplicates()  # idempotent on a clean index
    _same_index(tmp_path, idx, idx2, JaxIndex.build(stream))


def test_merge_overlapping_ranges_dedupe_sum(tmp_path):
    parts = ([(0, {"x": 10, "y": 5}), (1, {"x": 20})], [(0, {"x": 7})])
    m = InvertedIndexData.merge([InvertedIndexData.build(p) for p in parts], doc_offsets=[0, 0])
    docs, vals = m.term_postings("x")
    assert sorted(zip(docs.tolist(), vals.tolist())) == [(0, 17), (1, 20)]
    assert vals.tolist() == sorted(vals.tolist(), reverse=True)
    docs, vals = m.term_postings("y")
    assert docs.tolist() == [0] and vals.tolist() == [5]
    jm = JaxIndex.merge([JaxIndex.build(p) for p in parts], doc_offsets=[0, 0])
    _same_index(tmp_path, m, jm)


def test_merge_disjoint_ranges_skip_dedupe():
    m = InvertedIndexData.merge([InvertedIndexData.build([(0, {"x": 10})]),
                                 InvertedIndexData.build([(0, {"x": 7})])])
    docs, vals = m.term_postings("x")
    assert docs.tolist() == [0, 1] and vals.tolist() == [10, 7]


def test_merge_overlap_saturates_and_matches_jax(tmp_path):
    """Overlapping seeded shards (an expansion index over its base corpus):
    sums saturate at 255 and equal the JAX package's, byte for byte."""
    rng = random.Random(3)
    base = _fuzz_docs(rng, 15)
    extra = _fuzz_docs(rng, 10)
    m = InvertedIndexData.merge([_build(base), _build(extra)], doc_offsets=[0, 5])
    jm = JaxIndex.merge([_build(base, JaxIndex), _build(extra, JaxIndex)], doc_offsets=[0, 5])
    assert int(m.impacts.max()) <= 255
    _same_index(tmp_path, m, jm)


def test_dedupe_keeps_impact_desc_doc_asc_order():
    rng = np.random.default_rng(0)
    stream = [(d, {f"t{i}": int(v) for i, v in enumerate(rng.integers(1, 100, 8))}) for d in range(40)]
    stream += [(d, {f"t{i}": int(v) for i, v in enumerate(rng.integers(1, 100, 8))})
               for d in range(0, 40, 3)]
    idx = InvertedIndexData.build(stream)
    jidx = JaxIndex.build(stream)
    for t in idx.vocab:
        docs, vals = idx.term_postings(t)
        assert len(set(docs.tolist())) == len(docs), "duplicate pair survived"
        order = np.lexsort((docs, vals.astype(np.int16) * -1))
        assert docs.tolist() == docs[order].tolist()
        jdocs, jvals = jidx.term_postings(t)
        assert docs.tolist() == jdocs.tolist() and vals.tolist() == jvals.tolist()


def test_deduped_index_keeps_bf16_dense():
    """A built index (duplicates summed, lattice <= 255) keeps the hybrid
    engine's bf16 rows."""
    import torch

    from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine

    stream = [(d, {"hot": 100}) for d in range(64)]
    idx = InvertedIndexData.build(stream + stream)
    eng = HybridSearchEngine(idx, heavy_min=2, device="cpu")
    assert eng.t_heavy == 1 and eng.dense.dtype == torch.bfloat16
    assert eng.score_batch([{"hot"}], 3)[0][0][1] == 200.0
