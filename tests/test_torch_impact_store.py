"""The port's binary impact store against the JAX package's, on the CPU.

Mirrors ``tests/test_impact_store.py`` (but its Anserini export, not
ported) and ``tests/test_store_crash_fuzz.py``: the same seeded documents go
through both writers, readers, quantizers and inverters, and every file
they write must be byte-equal; the store route's final index must equal the
text route's, byte for byte, in both packages.
"""

import json
import os
import random

import numpy as np
import pytest

from improving_learned_index_tpu.index import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.index import format_line as jax_format_line
from improving_learned_index_tpu.index.impact_store import ImpactStore as JaxStore
from improving_learned_index_tpu.index.impact_store import ImpactStoreWriter as JaxWriter
from improving_learned_index_tpu.index.impact_store import _exact_round3 as jax_round3
from improving_learned_index_tpu.index.impact_store import quantize_store as jax_quantize_store
from improving_learned_index_tpu.index.impact_store import (
    store_from_forward_text as jax_store_from_text,
)
from improving_learned_index_tpu.index.impact_store import store_to_forward_text as jax_store_to_text
from improving_learned_index_tpu_torch.index.forward_index import format_line, quantize_file
from improving_learned_index_tpu_torch.index.impact_store import (
    ImpactStore,
    ImpactStoreWriter,
    _exact_round3,
    is_impact_store,
    quantize_store,
    store_from_forward_text,
    store_to_forward_text,
)
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData

TERMS = ["apple", "banana", "cherry", "négociation", "x|y", "##ing", ":", "zz"]
STORE_FILES = ("counts.bin", "term_ids.bin", "values.bin", "vocab.txt", "meta.json", "format.json")
INDEX_FILES = ("inverted_index.dat", "inverted_index.idx", "vocab.txt")


def _rand_docs(n_docs=40, seed=0):
    """Per-doc unique (term, float impact) lists, incl. an empty doc and a
    term whose every impact quantizes to zero (vocab-compaction case)."""
    rng = random.Random(seed)
    docs = []
    for d in range(n_docs):
        if d == 7:
            docs.append([])
            continue
        terms = rng.sample(TERMS, rng.randint(1, len(TERMS) - 1))
        doc = [(t, rng.uniform(0.001, 4.0)) for t in terms if t != "zz"]
        if "zz" in terms:
            doc.append(("zz", rng.uniform(1e-5, 1e-4)))  # always -> q == 0
        docs.append(doc)
    return docs


def _same_files(a, b, names):
    for name in names:
        assert (a / name).exists() == (b / name).exists(), name
        if (a / name).exists():
            assert (a / name).read_bytes() == (b / name).read_bytes(), name


def _write_both(tmp_path, docs, tag=""):
    """The same docs through the port's and the JAX writers (text and
    store); the port's text equals the JAX text byte for byte."""
    text = tmp_path / f"fwd{tag}.txt"
    with open(text, "w", encoding="utf-8") as f, ImpactStoreWriter(tmp_path / f"port{tag}.store") as w, \
            JaxWriter(tmp_path / f"jax{tag}.store") as jw:
        for doc in docs:
            assert format_line(doc) == jax_format_line(doc)
            f.write(format_line(doc) + "\n")
            w.add_doc(doc)
            jw.add_doc(doc)
    _same_files(tmp_path / f"port{tag}.store", tmp_path / f"jax{tag}.store", STORE_FILES)
    return text, tmp_path / f"port{tag}.store", tmp_path / f"jax{tag}.store"


def test_exact_round3_matches_jax_and_python_round():
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.gamma(2.0, 0.35, size=20_000),
        rng.uniform(0, 100, size=20_000),
        np.array([0.0005, 0.0015, 0.0025, 1.0005, 2.6755, 0.57350001,
                  0.5734999999, 12.3455, 0.1235, 0.0, 255.0004999]),
        np.float64(np.random.default_rng(1).gamma(2, 0.35, 5_000).astype(np.float32)),
    ])
    got = _exact_round3(vals)
    np.testing.assert_array_equal(got, jax_round3(vals))
    for v, g in zip(vals.tolist()[-5_100:], got.tolist()[-5_100:]):
        assert g == round(v, 3), (v, g)


def test_add_doc_row_equals_add_doc_and_jax(tmp_path):
    rng = np.random.default_rng(2)
    terms = [f"t{i}" for i in range(40)]
    rows = [rng.gamma(2.0, 0.35, size=40).astype(np.float32) for _ in range(50)]
    a, b, j = (ImpactStoreWriter(tmp_path / "a"), ImpactStoreWriter(tmp_path / "b"),
               JaxWriter(tmp_path / "j"))
    for row in rows:
        a.add_doc([(t, float(v)) for t, v in zip(terms, row)])
        b.add_doc_row(terms, row)
        j.add_doc_row(terms, row)
    for w in (a, b, j):
        w.close()
    _same_files(tmp_path / "a", tmp_path / "b", STORE_FILES)
    _same_files(tmp_path / "b", tmp_path / "j", STORE_FILES)


def test_store_roundtrip_reader(tmp_path):
    docs = _rand_docs()
    _, port, jax = _write_both(tmp_path, docs)
    assert is_impact_store(port) and not is_impact_store(tmp_path / "nothing")
    store, jstore = ImpactStore(port), JaxStore(jax)
    assert store.num_docs == jstore.num_docs == len(docs)
    assert store.num_postings == jstore.num_postings
    assert store.global_max() == jstore.global_max()
    got = dict(store.iter_docs())
    assert got == dict(jstore.iter_docs())
    for d, doc in enumerate(docs):
        assert got[d] == {t: round(float(v), 3) for t, v in doc}


def test_store_to_text_matches_format_line(tmp_path):
    docs = _rand_docs(seed=1)
    text, port, jax = _write_both(tmp_path, docs)
    store_to_forward_text(port, tmp_path / "p.txt")
    jax_store_to_text(jax, tmp_path / "j.txt")
    assert (tmp_path / "p.txt").read_bytes() == text.read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_quantize_store_byte_parity(tmp_path):
    """quantize_store equals the JAX one file for file, and the text
    quantizer through the store's text export."""
    docs = _rand_docs(seed=2)
    text, port, jax = _write_both(tmp_path, docs)
    max_text = quantize_file(text, tmp_path / "q.txt")
    assert quantize_store(port, tmp_path / "pq") == jax_quantize_store(jax, tmp_path / "jq") == max_text
    _same_files(tmp_path / "pq", tmp_path / "jq", STORE_FILES)
    store_to_forward_text(tmp_path / "pq", tmp_path / "pq.txt")
    assert (tmp_path / "pq.txt").read_bytes() == (tmp_path / "q.txt").read_bytes()


def test_quantize_store_chunked_matches_monolithic(tmp_path):
    docs = _rand_docs(seed=7)
    _, port, jax = _write_both(tmp_path, docs)
    quantize_store(port, tmp_path / "q_big")
    quantize_store(port, tmp_path / "q_small", doc_block=3)
    jax_quantize_store(jax, tmp_path / "q_jax", doc_block=5)
    _same_files(tmp_path / "q_small", tmp_path / "q_big", STORE_FILES)
    _same_files(tmp_path / "q_small", tmp_path / "q_jax", STORE_FILES)


def test_legacy_f64_store_reads_and_quantizes_identically(tmp_path):
    """A v1 store (float64 values) stays readable and quantizes to the same
    bytes as the milli_i32 store, in both packages."""
    docs = _rand_docs(seed=11)
    _, port, _ = _write_both(tmp_path, docs)
    v2 = ImpactStore(port)
    assert v2.values_format == "milli_i32"
    leg = tmp_path / "legacy.store"
    leg.mkdir()
    np.asarray(v2.counts).tofile(leg / "counts.bin")
    np.asarray(v2.term_ids).tofile(leg / "term_ids.bin")
    v2.value_block(0, v2.num_postings).tofile(leg / "values.bin")
    (leg / "vocab.txt").write_bytes((port / "vocab.txt").read_bytes())
    (leg / "meta.json").write_text(json.dumps(
        {"version": 1, "num_docs": v2.num_docs, "num_postings": v2.num_postings,
         "quantized": False, "bits": 8, "max_val": None}))
    lst = ImpactStore(leg)
    assert lst.values_format == "f64"
    assert dict(lst.iter_docs()) == dict(v2.iter_docs()) == dict(JaxStore(leg).iter_docs())
    quantize_store(port, tmp_path / "q_v2")
    quantize_store(leg, tmp_path / "q_leg")
    jax_quantize_store(leg, tmp_path / "q_jleg")
    _same_files(tmp_path / "q_leg", tmp_path / "q_v2", ("counts.bin", "term_ids.bin", "values.bin"))
    _same_files(tmp_path / "q_leg", tmp_path / "q_jleg", STORE_FILES)


def test_final_index_byte_parity(tmp_path):
    """from_impact_store over a quantized store: byte-equal to the text
    route's index and to the JAX package's from_impact_store."""
    docs = _rand_docs(seed=3)
    text, port, _ = _write_both(tmp_path, docs)
    quantize_file(text, tmp_path / "q.txt")
    quantize_store(port, tmp_path / "q.store")
    idx_text = InvertedIndexData.from_forward_index(tmp_path / "q.txt")
    idx_store = InvertedIndexData.from_impact_store(tmp_path / "q.store")
    assert "zz" not in idx_text.term_to_id
    assert idx_text.vocab == idx_store.vocab
    idx_text.save(tmp_path / "inv_text")
    idx_store.save(tmp_path / "inv_store")
    JaxIndex.from_impact_store(tmp_path / "q.store").save(tmp_path / "inv_jax")
    _same_files(tmp_path / "inv_store", tmp_path / "inv_text", INDEX_FILES)
    _same_files(tmp_path / "inv_store", tmp_path / "inv_jax", INDEX_FILES)


def test_invert_requires_quantized_store(tmp_path):
    _, port, _ = _write_both(tmp_path, _rand_docs(seed=4))
    with pytest.raises(ValueError, match="quantized"):
        InvertedIndexData.from_impact_store(port)


def test_store_from_forward_text_converter(tmp_path):
    docs = _rand_docs(seed=5)
    text, _, _ = _write_both(tmp_path, docs)
    store = store_from_forward_text(text, tmp_path / "conv.store")
    jax_store_from_text(text, tmp_path / "jconv.store")
    _same_files(tmp_path / "conv.store", tmp_path / "jconv.store", STORE_FILES)
    store_to_forward_text(store, tmp_path / "back.txt")
    assert (tmp_path / "back.txt").read_bytes() == text.read_bytes()
    quantize_file(text, tmp_path / "q.txt")
    store_from_forward_text(tmp_path / "q.txt", tmp_path / "qconv.store", quantized=True)
    jax_store_from_text(tmp_path / "q.txt", tmp_path / "jqconv.store", quantized=True)
    _same_files(tmp_path / "qconv.store", tmp_path / "jqconv.store", STORE_FILES)


def test_cli_pipeline_with_store(tmp_path):
    """The port's quantize + invert CLIs take store directories and write
    the text route's final index and the JAX CLIs' files."""
    from improving_learned_index_tpu.cli import invert as jax_invert
    from improving_learned_index_tpu.cli import quantize as jax_quantize
    from improving_learned_index_tpu_torch.cli import invert as invert_cli
    from improving_learned_index_tpu_torch.cli import quantize as quantize_cli

    docs = _rand_docs(seed=6)
    text, port, jax = _write_both(tmp_path, docs)
    assert quantize_cli.main(["-i", str(text), "-o", str(tmp_path / "q.txt")]) == 0
    assert quantize_cli.main(["-i", str(port), "-o", str(tmp_path / "q.store"),
                              "--text_out", str(tmp_path / "qs.txt")]) == 0
    assert jax_quantize.main(["-i", str(jax), "-o", str(tmp_path / "jq.store"),
                              "--text_out", str(tmp_path / "jqs.txt")]) == 0
    assert (tmp_path / "qs.txt").read_bytes() == (tmp_path / "q.txt").read_bytes()
    assert (tmp_path / "qs.txt").read_bytes() == (tmp_path / "jqs.txt").read_bytes()
    _same_files(tmp_path / "q.store", tmp_path / "jq.store", STORE_FILES)
    assert invert_cli.main(["-i", str(tmp_path / "q.txt"), "-o", str(tmp_path / "inv_t")]) == 0
    assert invert_cli.main(["-i", str(tmp_path / "q.store"), "-o", str(tmp_path / "inv_s")]) == 0
    assert jax_invert.main(["-i", str(tmp_path / "jq.store"), "-o", str(tmp_path / "inv_j")]) == 0
    _same_files(tmp_path / "inv_s", tmp_path / "inv_t", INDEX_FILES)
    _same_files(tmp_path / "inv_s", tmp_path / "inv_j", INDEX_FILES)


class TestRobustness:
    def test_empty_store_roundtrip(self, tmp_path):
        with ImpactStoreWriter(tmp_path / "empty"):
            pass
        with JaxWriter(tmp_path / "jempty"):
            pass
        _same_files(tmp_path / "empty", tmp_path / "jempty", STORE_FILES)
        store = ImpactStore(tmp_path / "empty")
        assert store.num_docs == 0 and store.num_postings == 0
        quantize_store(tmp_path / "empty", tmp_path / "empty_q")
        q = ImpactStore(tmp_path / "empty_q")
        assert q.quantized and q.num_postings == 0
        store_to_forward_text(q, tmp_path / "empty.txt")
        assert (tmp_path / "empty.txt").read_text() == ""

    def test_empty_docs_only_store_opens(self, tmp_path):
        with ImpactStoreWriter(tmp_path / "zdocs") as w:
            w.add_doc([])
            w.add_doc([])
        store = ImpactStore(tmp_path / "zdocs")
        assert store.num_docs == 2 and store.num_postings == 0

    def test_quantize_store_clamps_instead_of_wrapping(self, tmp_path):
        with ImpactStoreWriter(tmp_path / "s") as w:
            w.add_doc([("a", 3.0), ("b", 1.0)])
        quantize_store(tmp_path / "s", tmp_path / "sq", max_val=1.0)
        jax_quantize_store(tmp_path / "s", tmp_path / "jsq", max_val=1.0)
        _same_files(tmp_path / "sq", tmp_path / "jsq", STORE_FILES)
        vals = np.asarray(ImpactStore(tmp_path / "sq").values)
        assert vals.max() == 255 and vals.min() > 0

    def test_add_doc_row_rejects_nan_inf(self, tmp_path):
        with ImpactStoreWriter(tmp_path / "nan") as w:
            for row in ([1.0, float("nan")], [float("inf")], [3.0e9]):
                with pytest.raises(ValueError, match="int32-milli"):
                    w.add_doc_row(["a", "b"][: len(row)], np.array(row))


def test_wide_vocab_streaming_invert_matches_build_and_jax(tmp_path):
    """from_impact_store's streaming two-pass branch (vocab > 131072) equals
    InvertedIndexData.build over the same postings and the JAX route."""
    rng = np.random.default_rng(7)
    nvocab, per_doc = 140_000, 100
    vocab = [f"t{i:06d}" for i in range(nvocab)]
    docs = []
    with ImpactStoreWriter(tmp_path / "wide", quantized=True) as w:
        for d in range(nvocab // per_doc):
            tids = np.arange(d * per_doc, (d + 1) * per_doc)
            vals = rng.integers(1, 256, per_doc)
            w.add_doc([(vocab[t], int(v)) for t, v in zip(tids, vals)])
            docs.append((d, {vocab[t]: int(v) for t, v in zip(tids, vals)}))
        for d in range(nvocab // per_doc, nvocab // per_doc + 200):
            tids = rng.choice(nvocab, size=per_doc, replace=False)
            vals = rng.integers(1, 4, per_doc)
            w.add_doc([(vocab[t], int(v)) for t, v in zip(tids, vals)])
            docs.append((d, {vocab[t]: int(v) for t, v in zip(tids, vals)}))
    got = InvertedIndexData.from_impact_store(tmp_path / "wide")
    want = InvertedIndexData.build(iter(docs), num_docs=len(docs))
    jax = JaxIndex.from_impact_store(tmp_path / "wide")
    assert got.vocab == want.vocab == jax.vocab
    for name in ("offsets", "doc_ids", "impacts"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        np.testing.assert_array_equal(getattr(got, name), getattr(jax, name))


# -- crash-point fuzz (tests/test_store_crash_fuzz.py) ------------------------

FUZZ_TERMS = [f"t{i}" for i in range(25)]


def _fuzz_docs(n=30, seed=0):
    rng = random.Random(seed)
    return [
        [(t, rng.uniform(0.001, 5.0)) for t in rng.sample(FUZZ_TERMS, rng.randint(0, 6))]
        for _ in range(n)
    ]


def _write_flushing(writer_cls, path, docs, flush_every=5):
    w = writer_cls(path)
    for i, d in enumerate(docs):
        w.add_doc(d)
        if (i + 1) % flush_every == 0:
            w._flush()
    return w


@pytest.mark.parametrize("seed", range(10))
def test_arbitrary_truncation_recovers_as_jax(tmp_path, seed):
    """Truncate a crashed store at seeded byte offsets (mid-element too),
    reopen it with resume=True in both packages: the same ``resume_docs``
    and byte-equal repaired files; finishing the corpus then gives the
    uninterrupted run's documents, in files equal to the JAX writer's."""
    rng = random.Random(seed)
    docs = _fuzz_docs(seed=seed)
    _write_flushing(ImpactStoreWriter, tmp_path / "clean", docs).close()

    crash = tmp_path / "crash"
    w = _write_flushing(ImpactStoreWriter, crash, docs)
    del w  # crash before close: the buffered tail is lost
    for name in rng.sample(["counts.bin", "term_ids.bin", "values.bin"], rng.randint(1, 2)):
        p = crash / name
        size = p.stat().st_size
        if size:
            os.truncate(p, rng.randrange(0, size))
    if rng.random() < 0.3:
        # a partial write of the next element: an unaligned tail
        item = 4
        p = crash / "values.bin"
        os.truncate(p, (p.stat().st_size // item) * item)
        with open(p, "ab") as f:
            f.write(bytes(rng.randrange(1, item)))
    jcrash = tmp_path / "jcrash"
    jcrash.mkdir()
    for name in os.listdir(crash):
        (jcrash / name).write_bytes((crash / name).read_bytes())

    w2, jw2 = ImpactStoreWriter(crash, resume=True), JaxWriter(jcrash, resume=True)
    n = w2.resume_docs
    assert n == jw2.resume_docs and 0 <= n <= len(docs)
    _same_files(crash, jcrash, STORE_FILES)
    for d in docs[n:]:
        w2.add_doc(d)
        jw2.add_doc(d)
    w2.close()
    jw2.close()
    _same_files(crash, jcrash, STORE_FILES)
    a, b = ImpactStore(crash), ImpactStore(tmp_path / "clean")
    assert a.num_docs == b.num_docs
    assert dict(a.iter_docs()) == dict(b.iter_docs()), f"seed={seed} n={n}"
