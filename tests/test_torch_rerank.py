"""The port's rerankers against the JAX package's: top-k files and their
recall, the cross-encoder (model, ``score_batch``, collate, loss and
gradients), ``ReRanker`` and ``CrossEncoderReRanker``, and the CLIs
``rerank``, ``cross_encoder_rerank`` and ``train --cross_encoder``.

Weights are carried across with ``models.hf_import.flax_params_to_port``;
a ``CrossEncoderModel`` has ``DeepImpactModel``'s parameter names.
Geometry: ``EncoderConfig.tiny`` (hidden 64, 2 layers, 4 heads), fp32
compute; the cross-encoder comparisons use a softplus head, so that its
scores are not mostly the ReLU's exact zeros.

Tolerances:
- the rerankers' host logic: byte-identical run files when both packages
  are handed the same impacts or scores (dyadic values, so no sum depends
  on its order), ties and an int 0 for a candidate that matches no query
  term included;
- model outputs at S=32 (the plain attention route on both sides): 2e-5;
  at S=128 (the JAX Pallas kernel in interpret mode, the port's kernel's
  plain version, both with bf16 q, k, v and probabilities): 2e-3, as
  ``tests/test_torch_encoder.py``;
- run files from the models: scores within 2e-5, candidates in the same
  order except where two scores lie within 4e-5 (a near-tie, counted);
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
from improving_learned_index_tpu.data import datasets as jds
from improving_learned_index_tpu.evaluation.reranker import CrossEncoderReRanker as JaxCrossReRanker
from improving_learned_index_tpu.evaluation.reranker import ReRanker as JaxReRanker
from improving_learned_index_tpu.evaluation.run_metrics import Metrics as JaxMetrics
from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
from improving_learned_index_tpu.models import DeepImpactCrossEncoder as JaxCrossEncoder
from improving_learned_index_tpu.models.encoder import CrossEncoderModel as JaxCrossModel
from improving_learned_index_tpu.models.encoder import init_params
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu.train import COLLATES as JAX_COLLATES
from improving_learned_index_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from improving_learned_index_tpu_torch.cli.build_vocab import main as build_vocab_main
from improving_learned_index_tpu_torch.cli.cross_encoder_rerank import main as cross_rerank_main
from improving_learned_index_tpu_torch.cli.rerank import main as rerank_main
from improving_learned_index_tpu_torch.cli.train import main as train_main
from improving_learned_index_tpu_torch.core.checkpoint import load_params
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.data import datasets as tds
from improving_learned_index_tpu_torch.evaluation import CrossEncoderReRanker, Metrics, ReRanker
from improving_learned_index_tpu_torch.models import (
    CrossEncoderModel,
    DeepImpact,
    DeepImpactCrossEncoder,
    flax_params_to_port,
)
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
from improving_learned_index_tpu_torch.text.processor import batch_arrays
from improving_learned_index_tpu_torch.train import COLLATES
from improving_learned_index_tpu_torch.train.trainer import make_loss_fn

PASSAGES = [
    "the quick brown fox jumps over the lazy dog",
    "a fast auburn fox leaped across a sleepy canine",
    "neural networks learn sparse representations of text",
    "inverted indexes map terms to document postings",
    "impact scores quantize term importance into bytes",
    "retrieval systems rank documents for user queries",
    "the dog sleeps while the fox runs through fields",
    "sparse retrieval needs exact top k answers",
    "zebra",
    "bytes and postings of the index",
    "queries rank the fields",
    "a canine and a fox",
]
QUERIES = {"q0": "quick fox", "q1": "sparse text retrieval", "q2": "document postings bytes",
           "q3": "sleepy dog"}
QRELS = {"q0": ["p0"], "q1": ["p2", "p7"], "q2": ["p3"], "q3": ["p1", "p6"]}
TRIPLES = [
    ("quick fox", "the quick brown fox jumps", "sleepy dog naps inside"),
    ("lazy dog", "the lazy dog sleeps here", "fast fox runs far away"),
    ("sparse index", "inverted indexes map terms postings", "the fox is quick"),
    ("neural text", "neural networks learn text", "dogs and foxes play"),
]
TOL = 2e-5


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsa, "interpret", True)


@pytest.fixture
def files(tmp_path):
    """collection, queries, qrels, a candidate run file (ranks out of line
    order, q0's deeper than the rest) and the same candidates as a top-k
    file; every query's candidates include the passage 'zebra' (p8), which
    matches no query term."""
    rng = np.random.default_rng(0)
    (tmp_path / "c.tsv").write_text("".join(f"p{i}\t{p}\n" for i, p in enumerate(PASSAGES)))
    (tmp_path / "q.tsv").write_text("".join(f"{q}\t{t}\n" for q, t in QUERIES.items()))
    (tmp_path / "qrels.tsv").write_text("".join(f"{q}\t0\t{p}\t1\n" for q, ps in QRELS.items() for p in ps))
    run, topk = [], []
    for qi, qid in enumerate(QUERIES):
        n = 12 if qi == 0 else 7
        pids = [f"p{i}" for i in rng.permutation(len(PASSAGES))[:n]]
        if "p8" not in pids:
            pids[-1] = "p8"
        ranks = rng.permutation(n) + 1
        run += [f"{qid}\t{p}\t{r}\t{100 - r}.5\n" for p, r in zip(pids, ranks)]
        topk += [f"{qid}\t{p}\t{QUERIES[qid]}\t{PASSAGES[int(p[1:])]}\n" for p in pids]
    rng.shuffle(run)
    (tmp_path / "run.tsv").write_text("".join(run))
    (tmp_path / "topk.tsv").write_text("".join(topk))
    return tmp_path


def _vocab():
    return JaxVocab.build(PASSAGES + list(QUERIES.values()) + [" ".join(t) for t in TRIPLES], max_size=512)


def _configs(activation):
    jv = _vocab()
    fields = dataclasses.asdict(JaxConfig.tiny(vocab_size=len(jv), impact_activation=activation))
    fields["dtype"] = "float32"
    return jv, JaxConfig(**fields), EncoderConfig(**fields)


def _tokenizers(jv, max_length=32):
    return JaxTokenizer(jv, max_length=max_length), ImpactTokenizer(WordPieceVocab(jv.id_to_token),
                                                                    max_length=max_length)


@pytest.fixture(scope="module")
def cross32():
    """The JAX and the port DeepImpactCrossEncoder with the same weights, S=32."""
    jv, jc, tc = _configs("softplus")
    jt, tt = _tokenizers(jv)
    jm = JaxCrossEncoder(jc, jt, seed=0)
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jm.params), tc)
    return jm, DeepImpactCrossEncoder(tc, tt, state_dict=sd, device="cpu"), tc


def _run(path):
    out = {}
    for line in path.read_text().splitlines():
        qid, pid, rank, score = line.split("\t")
        out.setdefault(qid, []).append((pid, float(score)))
    return out


def _runs_close(got_path, want_path, tol=TOL):
    """Both run files rank each query's candidates alike: scores within
    ``tol``, pids in the same order except at near-ties.  Returns the
    near-tie swaps."""
    got, want = _run(got_path), _run(want_path)
    assert got.keys() == want.keys()
    swaps = 0
    for qid in want:
        g, w = got[qid], want[qid]
        wv = dict(w)
        assert sorted(dict(g)) == sorted(wv)
        assert all(abs(v - wv[p]) <= tol for p, v in g)
        for (gp, _), (wp, _) in zip(g, w):
            if gp != wp:
                assert abs(wv[gp] - wv[wp]) <= 2 * tol, (qid, gp, wp)
                swaps += 1
    return swaps


# -- top-k files and their recall ------------------------------------------------------


def test_topk_files_and_recall_match_jax(files):
    d = files
    ours, theirs = tds.TopKDataset(d / "topk.tsv"), jds.TopKDataset(d / "topk.tsv")
    for attr in ("queries", "passages", "top_k", "min_len", "max_len", "avg_len"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert len(ours) == len(theirs) == 4 and list(ours.keys()) == list(theirs.keys())
    assert (ours.min_len, ours.max_len) == (7, 12)
    qrels = tds.QueryRelevanceDataset(d / "qrels.tsv")
    recall = Metrics.evaluate_recall_for_top_k(qrels, ours)
    assert recall == JaxMetrics.evaluate_recall_for_top_k(jds.QueryRelevanceDataset(d / "qrels.tsv"), theirs)
    assert 0 < recall <= 1
    for k in (2000, 3):
        ours, theirs = tds.TopKRunFile(d / "run.tsv", k=k), jds.TopKRunFile(d / "run.tsv", k=k)
        assert ours.top_k == theirs.top_k and list(ours) == list(theirs) and len(ours) == len(theirs)
        assert ours["q0"] == theirs["q0"] and len(ours["q0"]) == min(k, 12)
    assert len(tds.TopKRunFile(d / "run.tsv")["q0"]) == 12  # the 2000 default


def test_bad_topk_files_raise_as_jax(files):
    d = files
    lines = (d / "topk.tsv").read_text().splitlines(keepends=True)
    cases = {"dup.tsv": (lines + lines[:1], "TopK file contains duplicates"),
             "mixed.tsv": (lines + [lines[0].replace("\tquick fox\t", "\tslow fox\t").replace("\tp", "\tpx", 1)],
                           "TopK file is not in the expected format")}
    for name, (text, message) in cases.items():
        (d / name).write_text("".join(text))
        for cls in (tds.TopKDataset, jds.TopKDataset):
            with pytest.raises(AssertionError, match=message):
                cls(d / name)
    (d / "few_qrels.tsv").write_text("q0\t0\tp0\t1\n")
    for metrics, ds in ((Metrics, tds), (JaxMetrics, jds)):
        with pytest.raises(AssertionError, match="TopK file contains queries not in the Qrels file"):
            metrics.evaluate_recall_for_top_k(ds.QueryRelevanceDataset(d / "few_qrels.tsv"),
                                              ds.TopKDataset(d / "topk.tsv"))


# -- the rerankers' host logic: byte-identical run files ------------------------------------


class _Impacts:
    """A stand-in model: each passage's term impacts from a table of dyadic
    values (ties included), its query terms from the tokenizer."""

    def __init__(self, tokenizer, seed=0):
        rng = np.random.default_rng(seed)
        self.tokenizer, self.calls = tokenizer, []
        self.table = {p: [(t, float(rng.integers(0, 6)) / 4) for t in dict.fromkeys(p.split())]
                      for p in PASSAGES}

    def process_query(self, query):
        return self.tokenizer.process_query(query)

    def get_impact_scores_batch(self, docs):
        self.calls.append(len(docs))
        return [self.table[d] for d in docs]


class _Scores:
    """A stand-in cross-encoder: fp32 dyadic scores (zeros and ties
    included) by (passage, query)."""

    def process_cross_encoder_documents_and_query(self, docs, query):
        return [(d, query) for d in docs]

    def score_batch(self, encs):
        return np.asarray([(len(d) * 7 + len(q) * 3) % 5 / 8 for d, q in encs], np.float32)


@pytest.mark.parametrize("final_k,batch_size", [(1000, 128), (5, 3)])
def test_reranker_writes_the_jax_run_file(files, final_k, batch_size):
    d = files
    jv = _vocab()
    jt, tt = _tokenizers(jv)
    args = (d / "run.tsv", d / "q.tsv", d / "c.tsv")
    ours, theirs = _Impacts(tt), _Impacts(jt)
    assert ReRanker(ours, *args, d / "port.run", batch_size=batch_size, final_k=final_k).run() == 4
    assert JaxReRanker(theirs, *args, d / "jax.run", batch_size=batch_size, final_k=final_k).run() == 4
    text = (d / "port.run").read_text()
    assert text == (d / "jax.run").read_text()
    assert ours.calls == theirs.calls and max(ours.calls) <= batch_size
    assert sum(ours.calls) == len(PASSAGES)  # the cache spans queries
    lines = [line.split("\t") for line in text.splitlines()]
    assert any(pid == "p8" and score == "0" for _, pid, _, score in lines)  # matches no term
    assert max(int(rank) for _, _, rank, _ in lines) == min(final_k, 12)


def test_cross_encoder_reranker_writes_the_jax_run_file(files):
    d = files
    for batch_size in (32, 3):
        CrossEncoderReRanker(_Scores(), d / "topk.tsv", d / "c.tsv", d / f"port{batch_size}.run",
                             batch_size=batch_size).run()
        JaxCrossReRanker(_Scores(), d / "topk.tsv", d / "c.tsv", d / f"jax{batch_size}.run",
                         batch_size=batch_size).run()
        text = (d / f"port{batch_size}.run").read_text()
        assert text == (d / f"jax{batch_size}.run").read_text()
        assert "\t0.0\n" in text and len(text.splitlines()) == 12 + 3 * 7


# -- the models ----------------------------------------------------------------------------


@pytest.mark.parametrize("seq,tol", [(32, TOL), (128, 2e-3)])
def test_cross_encoder_model_matches_jax(seq, tol):
    jv, jc, tc = _configs("softplus")
    jm = JaxCrossModel(jc)
    params = init_params(jm, jc, jax.random.PRNGKey(1))
    tm = CrossEncoderModel(tc)
    tm.load_state_dict(flax_params_to_port(jax.tree_util.tree_map(np.asarray, params), tc))
    _, tt = _tokenizers(jv, seq)
    arrays = batch_arrays([tt.process_document(f"{p} [SEP] {q}") for p in PASSAGES for q in ("quick fox",)])
    want = np.asarray(jm.apply({"params": params}, arrays["input_ids"], arrays["attention_mask"],
                               arrays["type_ids"]))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(arrays[k]) for k in ("input_ids", "attention_mask", "type_ids")),
                 use_kernels=False).numpy()
    assert got.shape == want.shape == (len(PASSAGES), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_score_batch_matches_jax(cross32):
    jm, tm, _ = cross32
    encs_t = tm.process_cross_encoder_documents_and_query(PASSAGES, "quick fox")
    encs_j = jm.process_cross_encoder_documents_and_query(PASSAGES, "quick fox")
    assert [e.ids for e in encs_t] == [e.ids for e in encs_j]
    got, want = tm.score_batch(encs_t), jm.score_batch(encs_j)
    assert got.dtype == np.float32 and got.shape == (len(PASSAGES),)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # no row is padded in: a row's score does not depend on its batch
    np.testing.assert_allclose(tm.score_batch(encs_t[:3]), got[:3], rtol=0, atol=1e-6)
    for empty in (tm.score_batch([]), jm.score_batch([])):
        assert empty.shape == (0,) and empty.dtype == np.float32


def test_cross_encoder_collate_matches_jax(cross32):
    jm, tm, _ = cross32
    want = JAX_COLLATES["cross_encoder"](TRIPLES, jm.tokenizer, 32)
    got = COLLATES["cross_encoder"](TRIPLES, tm.tokenizer, 32)
    assert got.keys() == want.keys() and got["group_size"] == want["group_size"] == 2
    for k in want:
        if k != "group_size":
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["input_ids"].shape == (2 * len(TRIPLES), 32)


def test_cross_encoder_loss_and_grads_match_jax(cross32):
    jm, tm, tc = cross32
    arrays = COLLATES["cross_encoder"](TRIPLES, tm.tokenizer, 32)
    batch = {k: v for k, v in arrays.items() if k != "group_size"}
    jl, jg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm.module, "cross_encoder")))(jm.params, batch)
    want = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jg), tc)
    tm.module.zero_grad(set_to_none=True)
    loss = make_loss_fn(tm.module, "cross_encoder", use_kernels=False)(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    got = {n: p.grad for n, p in tm.module.named_parameters()}
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=2e-4, atol=1e-6, err_msg=name)


def test_rerankers_with_the_models_rank_as_jax(files, cross32):
    d = files
    jv, jc, tc = _configs("relu")
    jt, tt = _tokenizers(jv)
    jm = JaxDeepImpact(jc, jt, seed=0)
    tm = DeepImpact(tc, tt, state_dict=flax_params_to_port(jax.tree_util.tree_map(np.asarray, jm.params), tc),
                    device="cpu")
    args = (d / "run.tsv", d / "q.tsv", d / "c.tsv")
    ReRanker(tm, *args, d / "port.run", batch_size=5).run()
    JaxReRanker(jm, *args, d / "jax.run", batch_size=5).run()
    assert _runs_close(d / "port.run", d / "jax.run") <= 2
    jx, tx, _ = cross32
    CrossEncoderReRanker(tx, d / "topk.tsv", d / "c.tsv", d / "port_x.run", batch_size=4).run()
    JaxCrossReRanker(jx, d / "topk.tsv", d / "c.tsv", d / "jax_x.run", batch_size=4).run()
    assert _runs_close(d / "port_x.run", d / "jax_x.run") <= 2
    assert len({s for q in _run(d / "port_x.run").values() for _, s in q}) > 20  # softplus: few ties


def test_checkpoints_carry_between_deep_impact_and_cross_encoder(cross32):
    _, tx, tc = cross32
    di = DeepImpact(tc, tx.tokenizer, state_dict=tx.module.state_dict(), device="cpu")
    back = DeepImpactCrossEncoder(tc, tx.tokenizer, state_dict=di.module.state_dict(), device="cpu")
    encs = tx.process_cross_encoder_documents_and_query(PASSAGES[:4], "fox")
    assert np.array_equal(back.score_batch(encs), tx.score_batch(encs))


# -- the CLIs on the CPU ------------------------------------------------------------------------


def _cli_data(d):
    build_vocab_main(["--collection_path", str(d / "c.tsv"), "--output_path", str(d / "vocab.txt"),
                      "--min_freq", "1"])
    return ImpactTokenizer(WordPieceVocab.load(d / "vocab.txt"), max_length=32)


def test_cli_rerank_writes_what_the_reranker_writes(files):
    d = files
    tok = _cli_data(d)
    common = ["--vocab_path", str(d / "vocab.txt"), "--tiny", "--device", "cpu", "--max_length", "32"]
    assert rerank_main(["--top_k_run_file_path", str(d / "run.tsv"), "--queries_path", str(d / "q.tsv"),
                        "--collection_path", str(d / "c.tsv"), "--output_path", str(d / "cli.run"),
                        "--batch_size", "4", *common]) == 0
    model = DeepImpact(EncoderConfig.tiny(vocab_size=len(tok.vocab)), tok, device="cpu")
    ReRanker(model, d / "run.tsv", d / "q.tsv", d / "c.tsv", d / "in.run", batch_size=4).run()
    assert (d / "cli.run").read_text() == (d / "in.run").read_text()
    assert len(_run(d / "cli.run")) == 4


def test_cli_train_cross_encoder_then_rerank(files):
    """cli.train --cross_encoder (unpacked: packing is not its default)
    writes DeepImpactCrossEncoder snapshots with finite losses; then
    cli.cross_encoder_rerank with the final one writes what the trained
    model gives in process."""
    d = files
    tok = _cli_data(d)
    (d / "t.tsv").write_text("q0\tp0\tp5\nq1\tp2\tp8\nq2\tp3\tp1\nq3\tp6\tp4\n")
    common = ["--vocab_path", str(d / "vocab.txt"), "--tiny", "--device", "cpu", "--max_length", "32"]
    assert train_main(["--dataset_path", str(d / "t.tsv"), "--queries_path", str(d / "q.tsv"),
                       "--collection_path", str(d / "c.tsv"), "--checkpoint_dir", str(d / "ck"),
                       "--batch_size", "2", "--lr", "1e-3", "--no_beir_eval", "--cross_encoder",
                       *common]) == 0
    final = d / "ck" / "DeepImpactCrossEncoder_final.pt"
    assert final.exists() and not (d / "ck" / "DeepImpact_final.pt").exists()
    assert cross_rerank_main(["--top_k_path", str(d / "topk.tsv"), "--collection_path", str(d / "c.tsv"),
                              "--output_path", str(d / "cli.run"), "--batch_size", "5",
                              "--checkpoint", str(final), *common]) == 0
    config = EncoderConfig.tiny(vocab_size=len(tok.vocab))
    trained = DeepImpactCrossEncoder(config, tok, state_dict=load_params(final), device="cpu")
    CrossEncoderReRanker(trained, d / "topk.tsv", d / "c.tsv", d / "in.run", batch_size=5).run()
    assert (d / "cli.run").read_text() == (d / "in.run").read_text()
    assert len((d / "cli.run").read_text().splitlines()) == 12 + 3 * 7
