"""The port's pairwise model (``models/pairwise.py``) against the JAX
package's: pair slots, the model's three outputs, composite-term impacts,
the pairwise collate, the ``pairwise_impact`` loss and its gradients, the
``Indexer``'s pairwise route and ``cli.train --pairwise``.

Weights are carried across with ``models.hf_import.flax_params_to_port``
(the pair head's kernel [2H+1, 1] to the ``Linear``'s [1, 2H+1]).
Geometry: ``EncoderConfig.tiny`` (hidden 64, 2 layers, 4 heads), fp32
compute, ReLU heads (the pairwise kind's), pair head in fp32 on both sides.

Tolerances:
- the model's outputs and the impacts: 2e-5 (the plain attention route on
  both sides at every S, since the maps are asked for; fp32 summation order
  only);
- a composite term is kept when ``round(score, 3)`` is not 0, so a pair
  scoring within 2e-5 of 0.0005 may be kept on one side only: such pairs
  are left out of the comparison and counted, and two impacts within 4e-5
  may swap places in the descending order (counted);
- loss rtol 1e-5 and gradients rtol 2e-4 / atol 1e-6, as
  ``tests/test_torch_train.py`` holds ``pairwise_ce`` at max_length 32.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import improving_learned_index_tpu.ops.short_attention as jsa
from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.core.config import IndexConfig as JaxIndexConfig
from improving_learned_index_tpu.index.forward_index import parse_line as jax_parse_line
from improving_learned_index_tpu.index.indexer import Indexer as JaxIndexer
from improving_learned_index_tpu.models.pairwise import DeepPairwiseImpact as JaxPairwise
from improving_learned_index_tpu.models.pairwise import build_pair_slots as jax_build_pair_slots
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu.train import COLLATES as JAX_COLLATES
from improving_learned_index_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from improving_learned_index_tpu_torch.cli.build_vocab import main as build_vocab_main
from improving_learned_index_tpu_torch.cli.index import main as index_main
from improving_learned_index_tpu_torch.cli.train import main as train_main
from improving_learned_index_tpu_torch.core.checkpoint import load_params
from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig
from improving_learned_index_tpu_torch.index.forward_index import parse_line
from improving_learned_index_tpu_torch.index.indexer import Indexer
from improving_learned_index_tpu_torch.models import (
    DeepImpact,
    DeepPairwiseImpact,
    build_pair_slots,
    flax_params_to_port,
)
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
from improving_learned_index_tpu_torch.text.processor import batch_arrays
from improving_learned_index_tpu_torch.train import COLLATES
from improving_learned_index_tpu_torch.train.trainer import make_loss_fn

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
]
TRIPLES = [
    ("quick fox", "the quick brown fox jumps", "sleepy dog naps inside"),
    ("lazy dog", "the lazy dog sleeps here", "fast fox runs far away"),
    ("sparse index terms", "inverted indexes map terms postings", "the fox is quick"),
    ("neural text", "neural networks learn text", "dogs and foxes play"),
]
TOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsa, "interpret", True)


def _pair(max_length, max_pairs=256):
    """The JAX and the port DeepPairwiseImpact with the same fp32 tiny weights."""
    jv = JaxVocab.build(CORPUS + [" ".join(t) for t in TRIPLES], max_size=512)
    fields = dataclasses.asdict(JaxConfig.tiny(vocab_size=len(jv)))
    fields["dtype"] = "float32"
    jc, tc = JaxConfig(**fields), EncoderConfig(**fields)
    jm = JaxPairwise(jc, JaxTokenizer(jv, max_length=max_length), seed=0, max_pairs=max_pairs)
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jm.params), tc)
    assert sd["pairwise_head.weight"].shape == (1, 2 * tc.hidden_size + 1)
    tm = DeepPairwiseImpact(tc, ImpactTokenizer(WordPieceVocab(jv.id_to_token), max_length=max_length),
                            state_dict=sd, device="cpu", max_pairs=max_pairs)
    return jm, tm, tc


@pytest.fixture(scope="module")
def pair32():
    return _pair(32)


def _aligned(got, want, tol=TOL):
    """Two descending (term, impact) lists: composite terms within ``tol``
    of the 0.0005 cut in either are dropped; the rest must hold the same
    terms with impacts within ``tol``, in the same order except where two
    impacts lie within 2 x ``tol`` (a near-tie).  Returns (dropped, swaps)."""
    band = {t for t, v in got + want if "|" in t and abs(v - 0.0005) <= tol}
    g = [(t, v) for t, v in got if t not in band]
    w = [(t, v) for t, v in want if t not in band]
    wv = dict(w)
    assert sorted(t for t, _ in g) == sorted(wv)
    assert all(abs(v - wv[t]) <= tol for t, v in g)
    swaps = 0
    for (gt, gv), (wt, _) in zip(g, w):
        if gt != wt:
            assert abs(wv[gt] - wv[wt]) <= 2 * tol, (gt, wt)
            swaps += 1
    return len(band), swaps


@pytest.mark.parametrize("directed", [False, True])
def test_build_pair_slots_match_jax(directed):
    indices = [[5, 1, 3], [], [2], [9, 4, 7, 1, 6, 8], list(range(1, 12))]
    for max_pairs in (1, 4, 16, 64):
        want = jax_build_pair_slots(indices, max_pairs, directed=directed)
        got = build_pair_slots(indices, max_pairs, directed=directed)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("seq,directed", [(32, False), (32, True), (128, False)])
def test_pairwise_model_matches_jax(seq, directed):
    """At S=128 the JAX trunk would take its Pallas kernel, and the port's
    its kernel's plain version with bf16 probabilities: both leave it for
    the plain route because the maps are asked for, so 2e-5 holds."""
    jm, tm, _ = _pair(seq, max_pairs=24)
    encs = [tm.process_document(d) for d in CORPUS]
    arrays = batch_arrays(encs)
    idx = [sorted(e.term_to_token_index.values()) for e in encs]
    pair_idx, pair_mask = build_pair_slots(idx, 24, directed=directed)
    want = jm(arrays["input_ids"], arrays["attention_mask"], arrays["type_ids"], pair_idx, pair_mask)
    got = tm(arrays["input_ids"], arrays["attention_mask"], arrays["type_ids"], pair_idx, pair_mask)
    for name, g, w in zip(("single", "pair_scores", "max_attn"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32, name
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL, err_msg=name)
    assert (got[2][~pair_mask] == 0).all() and (got[1][~pair_mask] == 0).all()
    assert (got[2][pair_mask] > 0).all() and (got[1][pair_mask] > 0).any()


def test_pairwise_impacts_match_jax(pair32):
    jm, tm, _ = pair32
    want, got = jm.get_impact_scores_batch(CORPUS), tm.get_impact_scores_batch(CORPUS)
    assert len(got) == len(want) == len(CORPUS)
    dropped = swaps = 0
    for g, w in zip(got, want):
        assert all(isinstance(v, float) for _, v in g)
        d, s = _aligned(g, w)
        dropped, swaps = dropped + d, swaps + s
    composite = sum("|" in t for doc in got for t, _ in doc)
    assert composite > 20, composite
    assert dropped <= 2 and swaps <= 2, (dropped, swaps)
    assert tm.get_impact_scores_batch([]) == []


def test_max_pairs_cut_matches_jax():
    jm, tm, _ = _pair(32, max_pairs=5)
    docs = CORPUS[:3]
    for g, w in zip(tm.get_impact_scores_batch(docs), jm.get_impact_scores_batch(docs)):
        _aligned(g, w)
        assert sum("|" in t for t, _ in g) <= 5


def test_pairwise_collate_matches_jax(pair32):
    jm, tm, _ = pair32
    want = JAX_COLLATES["pairwise_impact"](TRIPLES, jm.tokenizer, 32)
    got = COLLATES["pairwise_impact"](TRIPLES, tm.tokenizer, 32)
    assert got.keys() == want.keys() and got["group_size"] == want["group_size"] == 2
    for k in want:
        if k != "group_size":
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["pair_mask"].any()


def test_pairwise_loss_and_grads_match_jax(pair32):
    jm, tm, tc = pair32
    arrays = COLLATES["pairwise_impact"](TRIPLES, tm.tokenizer, 32)
    batch = {k: v for k, v in arrays.items() if k != "group_size"}
    jl, jg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm.module, "pairwise_impact")))(jm.params, batch)
    want = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jg), tc)
    tm.module.zero_grad(set_to_none=True)
    loss = make_loss_fn(tm.module, "pairwise_impact")(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got = {n: p.grad for n, p in tm.module.named_parameters()}
    assert got.keys() == want.keys() and float(got["pairwise_head.weight"].abs().max()) > 0
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-4, atol=1e-6, err_msg=name)


def test_pairwise_indexer_matches_jax(pair32, tmp_path):
    """The forward-index text of both Indexers, term lists and printed
    values equal away from the rounding band: a value within 2e-5 of a
    ``round(v, 3)`` boundary (or of the 0.0005 cut) may print apart."""
    jm, tm, _ = pair32
    coll = tmp_path / "c.tsv"
    coll.write_text("".join(f"{i}\t{t}\n" for i, t in enumerate(CORPUS)), encoding="utf-8")
    JaxIndexer(jm, JaxIndexConfig(max_length=32, max_terms=32, model_batch_size=4)).index_to_file(
        coll, tmp_path / "jax.txt")
    Indexer(tm, IndexConfig(max_length=32, max_terms=32, model_batch_size=4)).index_to_file(
        coll, tmp_path / "port.txt")
    raw = [a + b for a, b in zip(tm.get_impact_scores_batch(CORPUS), jm.get_impact_scores_batch(CORPUS))]
    want = [jax_parse_line(x) for x in (tmp_path / "jax.txt").read_text(encoding="utf-8").splitlines()]
    got = [parse_line(x) for x in (tmp_path / "port.txt").read_text(encoding="utf-8").splitlines()]
    assert len(got) == len(want) == len(CORPUS)
    banded = 0
    for g, w, r in zip(got, want, raw):
        band = {t for t, v in r if abs((v * 1000) % 1 - 0.5) * 1e-3 <= TOL}
        banded += len(band)
        assert [t for t in g if t not in band] == [t for t in w if t not in band]
        assert all(g[t] == w[t] for t in g if t not in band)
    assert any("|" in t for doc in got for t in doc)
    # each value lies in the band with probability ~4% (2 x 2e-5 of 1e-3)
    assert banded <= 0.1 * sum(map(len, got)), banded


def test_deep_impact_state_dict_loads_with_a_seeded_pair_head(pair32):
    """A DeepImpact checkpoint (no pair head) loads; the pair head is the
    seed's draw, the trunk and impact head the checkpoint's, so the
    single-term impacts are DeepImpact's."""
    _, tm, tc = pair32
    sd = {k: v for k, v in tm.module.state_dict().items() if not k.startswith("pairwise_head.")}
    a = DeepPairwiseImpact(tc, tm.tokenizer, state_dict=sd, seed=3, device="cpu")
    b = DeepPairwiseImpact(tc, tm.tokenizer, state_dict=sd, seed=3, device="cpu")
    assert torch.equal(a.module.pairwise_head.weight, b.module.pairwise_head.weight)
    assert not torch.equal(a.module.pairwise_head.weight, tm.module.pairwise_head.weight)
    single = dict(DeepImpact(tc, tm.tokenizer, state_dict=sd, device="cpu").get_impact_scores(CORPUS[0]))
    got = {t: v for t, v in a.get_impact_scores(CORPUS[0]) if "|" not in t}
    assert got.keys() == single.keys()
    assert all(abs(got[t] - single[t]) <= TOL for t in got)


def test_cli_train_pairwise_then_index(tmp_path):
    """cli.train --pairwise on the CPU (unpacked: packing is not its
    default), its DeepPairwiseImpact snapshot, then cli.index --model_kind
    pairwise writes composite terms."""
    d = tmp_path
    passages = [t[1] for t in TRIPLES] + [t[2] for t in TRIPLES]
    (d / "c.tsv").write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(passages)))
    (d / "q.tsv").write_text("".join(f"{i}\t{t[0]}\n" for i, t in enumerate(TRIPLES)))
    (d / "t.tsv").write_text("".join(f"{i}\t{i}\t{i + 4}\n" for i in range(4)))
    build_vocab_main(["--collection_path", str(d / "c.tsv"), "--output_path", str(d / "vocab.txt"),
                      "--min_freq", "1"])
    common = ["--vocab_path", str(d / "vocab.txt"), "--tiny", "--device", "cpu", "--max_length", "32"]
    assert train_main(["--dataset_path", str(d / "t.tsv"), "--queries_path", str(d / "q.tsv"),
                       "--collection_path", str(d / "c.tsv"), "--checkpoint_dir", str(d / "ck"),
                       "--batch_size", "2", "--lr", "1e-3", "--no_beir_eval", "--pairwise", *common]) == 0
    final = d / "ck" / "DeepPairwiseImpact_final.pt"
    assert final.exists() and "pairwise_head.weight" in load_params(final)
    index_main(["--collection_path", str(d / "c.tsv"), "--output_file_path", str(d / "fwd.txt"),
                "--model_kind", "pairwise", "--checkpoint", str(final), *common])
    lines = (d / "fwd.txt").read_text().splitlines()
    assert len(lines) == len(passages) and any("|" in line for line in lines)
