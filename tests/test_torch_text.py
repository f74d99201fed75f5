"""The port's encode-side text stack against the JAX package's, exactly:
vocabulary construction, WordPiece, document processing, batching, sequence
packing and collection streaming on a corpus with duplicates, punctuation,
unknown characters and truncation."""

import json

import numpy as np
import pytest

from improving_learned_index_tpu.data.datasets import stream_collection as jax_stream
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu.text.packing import pack_documents as jax_pack
from improving_learned_index_tpu.text.processor import batch_arrays as jax_batch_arrays
from improving_learned_index_tpu.text.processor import batch_term_slots as jax_batch_term_slots
from improving_learned_index_tpu.text.wordpiece import WordPieceTokenizer as JaxWordPiece
from improving_learned_index_tpu_torch.data import stream_collection
from improving_learned_index_tpu_torch.text import (
    ImpactTokenizer,
    WordPieceTokenizer,
    WordPieceVocab,
    batch_arrays,
    batch_term_slots,
    pack_documents,
)


def _corpus(n=60, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)] + ["fox", "foxes", "running", "run", "Café", "naïve"]
    docs = []
    for i in range(n):
        ws = list(rng.choice(words, size=int(rng.integers(1, 90))))
        ws += ["fox", "fox", ",", "!", "(x)", "fox."]          # duplicates + punctuation
        docs.append(" ".join(ws))
    docs += ["", "   ", "only ! ? .", "zzzqqq unseen-chars ☃"]
    return docs


@pytest.fixture(scope="module")
def stacks():
    docs = _corpus()
    jv = JaxVocab.build(docs[:40], max_size=60, min_freq=2)
    tv = WordPieceVocab.build(docs[:40], max_size=60, min_freq=2)
    return docs, jv, tv


def test_vocab_build_matches_jax(stacks):
    docs, jv, tv = stacks
    assert tv.id_to_token == jv.id_to_token
    big_j = JaxVocab.build(docs * 20, max_size=500)       # > one 1000-text chunk
    assert WordPieceVocab.build(docs * 20, max_size=500).id_to_token == big_j.id_to_token


def test_wordpiece_matches_jax(stacks):
    _, jv, tv = stacks
    jw, tw = JaxWordPiece(jv), WordPieceTokenizer(tv)
    for word in ("fox", "foxes", "w17", "w3x9", "zzzz", "", "a" * 101, "café", "runningfox"):
        assert tw.tokenize_word(word) == jw.tokenize_word(word), word


@pytest.mark.parametrize("max_length", [16, 64, 128])
def test_process_document_and_batching_match_jax(stacks, max_length):
    docs, jv, tv = stacks
    jt, tt = JaxTokenizer(jv, max_length=max_length), ImpactTokenizer(tv, max_length=max_length)
    jenc = [jt.process_document(d) for d in docs]
    tenc = [tt.process_document(d) for d in docs]
    for a, b in zip(jenc, tenc):
        assert (a.ids, a.attention_mask, a.type_ids) == (b.ids, b.attention_mask, b.type_ids)
        assert list(a.term_to_token_index.items()) == list(b.term_to_token_index.items())
    assert any(len(e.term_to_token_index) < len(set(d.split())) for e, d in zip(tenc, docs))
    for key, arr in jax_batch_arrays(jenc).items():
        assert np.array_equal(batch_arrays(tenc)[key], arr) and batch_arrays(tenc)[key].dtype == np.int32
    for max_terms in (4, max_length):
        want, got = jax_batch_term_slots(jenc, max_terms), batch_term_slots(tenc, max_terms)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_query_document_mask_matches_jax(stacks):
    docs, jv, tv = stacks
    jt, tt = JaxTokenizer(jv, max_length=64), ImpactTokenizer(tv, max_length=64)
    for q in ("fox w3 w7 !", "nothing here", ""):
        je, jm = jt.process_query_and_document(q, docs[3])
        te, tm = tt.process_query_and_document(q, docs[3])
        assert je.ids == te.ids and np.array_equal(jm, tm)


@pytest.mark.parametrize("rows,max_terms", [(1, None), (3, 8), (8, None)])
def test_packer_matches_jax(stacks, rows, max_terms):
    docs, jv, tv = stacks
    jenc = [JaxTokenizer(jv, max_length=64).process_document(d) for d in docs]
    tenc = [ImpactTokenizer(tv, max_length=64).process_document(d) for d in docs]
    jb = list(jax_pack(jenc, 128, rows, max_terms))
    tb = list(pack_documents(tenc, 128, rows, max_terms))
    assert len(tb) == len(jb) > 1
    for a, b in zip(jb, tb):
        for name in ("input_ids", "segment_ids", "type_ids", "flat_slots", "term_offsets"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert a.terms == b.terms


def test_stream_collection_matches_jax(tmp_path):
    tsv = tmp_path / "c.tsv"
    tsv.write_text("0\tfirst passage\n\n7\tsecond\twith tab\n  \n9\tthird\n", encoding="utf-8")
    jl = tmp_path / "c.jsonl"
    jl.write_text(
        "\n".join(json.dumps(x) for x in (
            {"_id": "d1", "title": "T", "text": "body"}, {"_id": 2, "text": "no title"},
        )) + "\n",
        encoding="utf-8",
    )
    for path, kind in ((tsv, "msmarco"), (jl, "beir")):
        assert list(stream_collection(path, kind)) == list(jax_stream(path, kind))
    with pytest.raises(ValueError, match="unknown collection type"):
        list(stream_collection(tsv, "trec"))
