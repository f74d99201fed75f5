"""The port's encode chain (Indexer -> forward index -> quantize -> invert ->
rank) against the JAX package's, on the CPU, with the same weights carried
across by ``flax_params_to_port``.

The model is tiny and fp32, so both sides compute the same function up to
summation order (~1e-6).  Forward-index term lists must be identical;
impacts are compared as parsed floats within 2e-3, not as bytes: a value at
a ``round(v, 3)`` boundary can print one last digit apart.  Quantize and
invert are held byte for byte when both read the same input file.
"""

import dataclasses
import filecmp
import os

import jax
import numpy as np
import pytest
import torch

from improving_learned_index_tpu.cli.invert import main as jax_invert_main
from improving_learned_index_tpu.cli.quantize import main as jax_quantize_main
from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.core.config import IndexConfig as JaxIndexConfig
from improving_learned_index_tpu.index.forward_index import parse_line as jax_parse_line
from improving_learned_index_tpu.index.forward_index import quantize_file as jax_quantize_file
from improving_learned_index_tpu.index.indexer import Indexer as JaxIndexer
from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
from improving_learned_index_tpu.ops.quantize import quantize_array as jax_quantize_array
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu_torch.cli.build_vocab import main as build_vocab_main
from improving_learned_index_tpu_torch.cli.index import main as index_main
from improving_learned_index_tpu_torch.cli.invert import main as invert_main
from improving_learned_index_tpu_torch.cli.quantize import main as quantize_main
from improving_learned_index_tpu_torch.cli.rank import main as rank_main
from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig
from improving_learned_index_tpu_torch.index.forward_index import (
    ForwardIndex,
    format_line,
    format_quantized_line,
    parse_line,
    quantize_file,
)
from improving_learned_index_tpu_torch.index.indexer import (
    Indexer,
    _repair_text_forward,
    _truncate_text_forward,
)
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.models import DeepImpact, flax_params_to_port
from improving_learned_index_tpu_torch.ops.quantize import (
    global_max,
    quantize_array,
    quantize_device,
    quantize_scale,
    quantize_value,
)
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

FILES = ("vocab.txt", "inverted_index.idx", "inverted_index.dat")
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast auburn fox leaped across a sleepy canine",
    "neural networks learn sparse representations of text",
    "inverted indexes map terms to document postings",
    "impact scores quantize term importance into bytes, bytes and bytes!",
    "",
    "retrieval systems rank documents for user queries",
    "the dog sleeps while the fox runs through fields " * 4,
    "a b c d e f g h i j k l m n o p q r s t u v w x y z",
    "tpu systolic arrays multiply matrices in bfloat16",
]


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port DeepImpact with the same fp32 tiny weights."""
    jv = JaxVocab.build(CORPUS, max_size=512)
    tv = WordPieceVocab(jv.id_to_token)
    fields = dataclasses.asdict(JaxConfig.tiny(vocab_size=len(jv)))
    fields["dtype"] = "float32"
    jc, tc = JaxConfig(**fields), EncoderConfig(**fields)
    jm = JaxDeepImpact(jc, JaxTokenizer(jv, max_length=32), seed=0)
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jm.params), tc)
    tm = DeepImpact(tc, ImpactTokenizer(tv, max_length=32), state_dict=sd, device="cpu")
    return jm, tm


def _cfg(pack=False):
    return IndexConfig(max_length=32, max_terms=32, model_batch_size=4, pack_sequences=pack)


def _collection(tmp_path):
    coll = tmp_path / "collection.tsv"
    coll.write_text("".join(f"{i}\t{t}\n" for i, t in enumerate(CORPUS)), encoding="utf-8")
    return coll


def _assert_forward_close(got_path, want_path):
    got = [parse_line(x) for x in got_path.read_text(encoding="utf-8").splitlines()]
    want = [jax_parse_line(x) for x in want_path.read_text(encoding="utf-8").splitlines()]
    assert len(got) == len(want) == len(CORPUS)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert all(abs(g[t] - w[t]) <= 2e-3 for t in g)
    return got


@pytest.mark.parametrize("pack", [False, True])
def test_forward_index_matches_jax(tmp_path, pair, pack):
    jm, tm = pair
    coll = _collection(tmp_path)
    JaxIndexer(jm, JaxIndexConfig(**dataclasses.asdict(_cfg(pack)))).index_to_file(coll, tmp_path / "jax.txt")
    n = Indexer(tm, _cfg(pack)).index_to_file(coll, tmp_path / "port.txt")
    assert n == len(CORPUS)
    got = _assert_forward_close(tmp_path / "port.txt", tmp_path / "jax.txt")
    assert got[5] == {} and sum(map(len, got)) > 40


def test_quantize_and_invert_are_byte_identical(tmp_path, pair):
    jm, _ = pair
    coll = _collection(tmp_path)
    fwd = tmp_path / "fwd.txt"
    JaxIndexer(jm, JaxIndexConfig(max_length=32, max_terms=32, model_batch_size=4)).index_to_file(coll, fwd)
    for max_val in (None, 0.5):
        assert quantize_file(fwd, tmp_path / "q_port.txt", max_val) == jax_quantize_file(
            fwd, tmp_path / "q_jax.txt", max_val
        )
        assert filecmp.cmp(tmp_path / "q_port.txt", tmp_path / "q_jax.txt", shallow=False)
    quantize_main(["-i", str(fwd), "-o", str(tmp_path / "q_cli_port.txt")])
    jax_quantize_main(["-i", str(fwd), "-o", str(tmp_path / "q_cli_jax.txt")])
    assert filecmp.cmp(tmp_path / "q_cli_port.txt", tmp_path / "q_cli_jax.txt", shallow=False)
    q = tmp_path / "q_cli_jax.txt"
    InvertedIndexData.from_forward_index(q).save(tmp_path / "port")
    JaxIndex.from_forward_index(q).save(tmp_path / "jax")
    invert_main(["-i", str(q), "-o", str(tmp_path / "port_cli")])
    jax_invert_main(["-i", str(q), "-o", str(tmp_path / "jax_cli")])
    for name in FILES:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False)
        assert filecmp.cmp(tmp_path / "port_cli" / name, tmp_path / "jax_cli" / name, shallow=False)


def test_build_matches_jax_with_duplicates_and_zeros(tmp_path):
    rng = np.random.default_rng(4)
    docs = [(d, {f"t{t}": int(rng.integers(0, 256)) for t in rng.choice(200, 9, replace=False)})
            for d in range(300)]
    docs.append((7, {"t1": 9, "zz": 0}))  # a doc id fed twice: duplicate-sum path
    InvertedIndexData.build(docs).save(tmp_path / "port")
    JaxIndex.build(docs).save(tmp_path / "jax")
    for name in FILES:
        assert filecmp.cmp(tmp_path / "port" / name, tmp_path / "jax" / name, shallow=False)


def test_build_inverted_matches_jax(pair):
    """In-memory build: the same postings, impacts within one quantization
    step (an fp32 difference can cross an integer boundary)."""
    jm, tm = pair
    jidx, jmax = JaxIndexer(jm, JaxIndexConfig(max_length=32, max_terms=32, model_batch_size=4)).build_inverted(CORPUS)
    tidx, tmax = Indexer(tm, _cfg()).build_inverted(CORPUS)
    assert abs(tmax - jmax) <= 1e-5 * jmax

    def postings(idx):
        out = {}
        for t, term in enumerate(idx.vocab):
            for j in range(idx.offsets[t], idx.offsets[t + 1]):
                out[(term, int(idx.doc_ids[j]))] = int(idx.impacts[j])
            for j in range(idx.zero_offsets[t], idx.zero_offsets[t + 1]):
                out[(term, int(idx.zero_doc_ids[j]))] = 0
        return out

    pt, pj = postings(tidx), postings(jidx)
    assert pt.keys() == pj.keys()
    assert all(abs(pt[k] - pj[k]) <= 1 for k in pt)


def test_quantize_helpers_match_jax():
    vals = np.array([0.0, 0.001, 0.5, 1.2345, 2.0])
    scale = quantize_scale(2.0)
    assert np.array_equal(quantize_array(vals, scale), jax_quantize_array(vals, scale))
    assert [quantize_value(v, scale) for v in vals] == quantize_array(vals, scale).tolist()
    dev = quantize_device(torch.tensor(vals, dtype=torch.float32), scale)
    assert dev.dtype == torch.int32 and dev.tolist() == quantize_array(vals, scale).tolist()
    assert global_max([np.zeros(0), vals, np.array([0.3])]) == 2.0
    assert format_quantized_line([("a", 3), ("b", 250)]) == "a: 3, b: 250"
    assert parse_line(format_line([("a", 1.23456), ("b", 2)])) == {"a": 1.235, "b": 2.0}


def test_repair_and_truncate_text_forward(tmp_path):
    p = tmp_path / "fwd.txt"
    p.write_text("a: 1\nb: 2\nc: 3\nto")  # torn 4th line
    assert _repair_text_forward(p) == 3
    assert p.read_text() == "a: 1\nb: 2\nc: 3\n"
    _truncate_text_forward(p, 1)
    assert p.read_text() == "a: 1\n"
    assert _repair_text_forward(tmp_path / "missing.txt") == 0


def test_index_to_file_resume(tmp_path, pair):
    """A torn run resumes to the uninterrupted run's bytes; resuming a
    complete output is a no-op.  The store route writes a binary impact
    store whose quantized and inverted index equals the text route's, byte
    for byte; a torn dual-output run (store and text cut at different
    documents) resumes at the shorter one to the uninterrupted run's bytes;
    a rounding other than 3 decimals is refused with a store."""
    import dataclasses as dc

    from improving_learned_index_tpu_torch.index.impact_store import quantize_store

    _, tm = pair
    coll = _collection(tmp_path)
    indexer = Indexer(tm, _cfg())
    ref = tmp_path / "ref.txt"
    assert indexer.index_to_file(coll, ref) == len(CORPUS)
    lines = ref.read_text().splitlines(keepends=True)
    crash = tmp_path / "crash.txt"
    crash.write_text("".join(lines[:5]) + lines[5][:3] + "torn")
    assert indexer.index_to_file(coll, crash, resume=True) == len(CORPUS)
    assert crash.read_bytes() == ref.read_bytes()
    assert indexer.index_to_file(coll, crash, resume=True) == len(CORPUS)
    assert crash.read_bytes() == ref.read_bytes()

    both, store = tmp_path / "both.txt", tmp_path / "store"
    assert indexer.index_to_file(coll, both, store_path=store) == len(CORPUS)
    assert both.read_bytes() == ref.read_bytes()
    quantize_file(ref, tmp_path / "q.txt")
    quantize_store(store, tmp_path / "q.store")
    InvertedIndexData.from_forward_index(tmp_path / "q.txt").save(tmp_path / "inv_text")
    InvertedIndexData.from_impact_store(tmp_path / "q.store").save(tmp_path / "inv_store")
    for name in ("inverted_index.dat", "inverted_index.idx", "vocab.txt"):
        assert (tmp_path / "inv_store" / name).read_bytes() == (tmp_path / "inv_text" / name).read_bytes()

    crash_store = tmp_path / "crash.store"
    crash_store.mkdir()
    for f in store.iterdir():
        (crash_store / f.name).write_bytes(f.read_bytes())
    (crash_store / "meta.json").unlink()
    # the store keeps 3 documents and a torn fourth, the text 6 and a torn line
    counts = np.fromfile(store / "counts.bin", np.int32)
    keep = int(counts[:3].sum())
    os.truncate(crash_store / "counts.bin", 4 * 4)
    os.truncate(crash_store / "term_ids.bin", 4 * keep + 2)
    os.truncate(crash_store / "values.bin", 4 * keep)
    crash.write_text("".join(lines[:6]) + lines[6][:4])
    assert indexer.index_to_file(coll, crash, store_path=crash_store, resume=True) == len(CORPUS)
    assert crash.read_bytes() == ref.read_bytes()
    for name in ("counts.bin", "term_ids.bin", "values.bin", "vocab.txt", "meta.json"):
        assert (crash_store / name).read_bytes() == (store / name).read_bytes(), name
    with pytest.raises(ValueError, match="round_decimals=3"):
        Indexer(tm, dc.replace(_cfg(), round_decimals=2)).index_to_file(coll, ref, store_path=store)


@pytest.mark.parametrize("pack", [False, True])
def test_producer_error_surfaces(pair, pack):
    _, tm = pair

    def poisoned():
        yield CORPUS[0]
        yield CORPUS[1]
        raise RuntimeError("stream broke mid-collection")

    with pytest.raises(RuntimeError, match="stream broke"):
        list(Indexer(tm, _cfg(pack)).encode_documents(poisoned()))


def test_model_api_packed_equals_unpacked(pair):
    jm, tm = pair
    unpacked = tm.get_impact_scores_batch(CORPUS)
    packed = tm.get_impact_scores_batch_packed(CORPUS)
    want = jm.get_impact_scores_batch(CORPUS)
    for u, p, w in zip(unpacked, packed, want):
        assert [t for t, _ in u] == [t for t, _ in p] == [t for t, _ in w]
        assert all(abs(a - b) <= 1e-4 for (_, a), (_, b) in zip(u, p))
        assert all(abs(a - b) <= 1e-4 for (_, a), (_, b) in zip(u, w))
    encs = [tm.process_document(d) for d in CORPUS[:3]]
    raw = tm(np.asarray([e.ids for e in encs]), np.asarray([e.attention_mask for e in encs]))
    assert raw.shape == (3, 32, 1)
    via_raw = tm.compute_term_impacts([e.term_to_token_index for e in encs], raw)
    for r, u in zip(via_raw, unpacked[:3]):
        assert [t for t, _ in r] == [t for t, _ in u]
        assert all(abs(a - b) <= 1e-6 for (_, a), (_, b) in zip(r, u))
    assert tm.get_impact_scores(CORPUS[0]) == unpacked[0]


def test_cli_chain_on_cpu(tmp_path):
    """build_vocab -> index (the kernel's plain version at S=128) ->
    quantize -> invert -> rank, all through the port's CLIs with
    ``--device cpu``; the run file equals a numpy scorer over the index."""
    coll = _collection(tmp_path)
    vocab = tmp_path / "vocab.txt"
    assert build_vocab_main(["--collection_path", str(coll), "--output_path", str(vocab), "--min_freq", "1"]) == 0
    fwd, q, idx = tmp_path / "fwd.txt", tmp_path / "q.txt", tmp_path / "idx"
    for extra in ([], ["--pack"]):
        assert index_main([
            "--collection_path", str(coll), "--output_file_path", str(fwd), "--vocab_path", str(vocab),
            "--tiny", "--max_length", "128", "--model_batch_size", "4", "--device", "cpu", *extra,
        ]) == 0
        assert len(ForwardIndex(fwd)) == len(CORPUS)
    assert quantize_main(["-i", str(fwd), "-o", str(q)]) == 0
    assert invert_main(["-i", str(q), "-o", str(idx)]) == 0
    index = InvertedIndexData.load(idx, num_docs=len(CORPUS))
    assert index.num_postings > 10
    terms = index.vocab[:3]
    queries = tmp_path / "queries.tsv"
    queries.write_text(f"1\t{' '.join(terms)}\n2\t{terms[-1]} unknownword\n", encoding="utf-8")
    run = tmp_path / "run.tsv"
    assert rank_main(["--index_path", str(idx), "--queries_path", str(queries), "--output_path", str(run),
                      "--vocab_path", str(vocab), "--device", "cpu", "--top_k", "5"]) == 0
    fwd_q = ForwardIndex(q)
    for qid, qterms in (("1", terms), ("2", terms[-1:])):
        scores = {pid: sum(fwd_q[pid].get(t, 0) for t in qterms) for pid in range(len(fwd_q))}
        want = sorted(((s, pid) for pid, s in scores.items() if s > 0), key=lambda x: (-x[0], x[1]))[:5]
        got = [(float(s), int(p)) for q_, p, _, s in (x.split("\t") for x in run.read_text().splitlines())
               if q_ == qid]
        assert got == [(float(s), p) for s, p in want]
