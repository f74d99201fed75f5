"""The port's training slice against the JAX package's: losses, collates,
packing, the batch loader and datasets, loss and gradients of every ported
objective (packed and unpacked, both attention routes), the clipped AdamW
step, accumulation, resume, checkpoints and the eval record.

Weights are carried across with ``models.hf_import.flax_params_to_port``;
the JAX gradient tree goes through the same converter (a pure re-layout).
Geometry: ``EncoderConfig.tiny`` (hidden 64, 2 layers, 4 heads), fp32
compute, softplus head (no dead-ReLU zeros).

Tolerances:
- losses alone: rtol 1e-6 (the same fp32 ops);
- max_length 32 (the plain attention route on both sides): loss rtol 1e-5,
  gradients rtol 2e-4 / atol 1e-6, as the JAX package's own packed-vs-
  unpacked test (``tests/test_packed_training.py``);
- max_length 128 (the short-attention route: the JAX Pallas kernel in
  interpret mode and the port's plain version forward, the same bf16
  recompute backward): loss rtol 1e-4, each gradient leaf within 1e-2 of its
  largest entry, since a bf16 probability that the fp32 summation order
  moves by one ulp moves the gradients by ~2^-8 of their scale;
- the optimizer and accumulation: the same gradients go into both
  trainers, so params agree to rtol 1e-5 / atol 1e-7 (AdamW's rounding).
"""

import collections
import copy
import dataclasses
import gzip
import json
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import improving_learned_index_tpu.ops.short_attention as jsa
from improving_learned_index_tpu.core.checkpoint import CheckpointManager as JaxManager
from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.core.config import TrainConfig as JaxTrainConfig
from improving_learned_index_tpu.data import datasets as jds
from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
from improving_learned_index_tpu.parallel.dataloader import BatchLoader as JaxLoader
from improving_learned_index_tpu.train import COLLATES as JAX_COLLATES
from improving_learned_index_tpu.train import Trainer as JaxTrainer
from improving_learned_index_tpu.train import losses as jlosses
from improving_learned_index_tpu.train import packed as jpacked
from improving_learned_index_tpu.train.trainer import make_loss_fn as jax_make_loss_fn
from improving_learned_index_tpu_torch.core.checkpoint import (
    CheckpointManager,
    load_params,
    save_params,
)
from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
from improving_learned_index_tpu_torch.data import datasets as tds
from improving_learned_index_tpu_torch.models import DeepImpact, flax_params_to_port
from improving_learned_index_tpu_torch.parallel.dataloader import BatchLoader
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
from improving_learned_index_tpu_torch.train import COLLATES, Trainer, losses, packed
from improving_learned_index_tpu_torch.train.trainer import make_loss_fn

TRIPLES = [
    ("quick fox", "the quick brown fox jumps", "sleepy dog naps inside"),
    ("lazy dog", "the lazy dog sleeps here", "fast fox runs far away"),
    ("sparse index", "inverted indexes map terms postings", "the fox is quick"),
    ("neural text", "neural networks learn text", "dogs and foxes play"),
]
DISTIL = [(q, [(pos, 9.0), (neg, 1.0), (TRIPLES[(i + 1) % 4][1], 4.0)])
          for i, (q, pos, neg) in enumerate(TRIPLES)]


@pytest.fixture(scope="module")
def port_tokenizer(tiny_corpus):
    return ImpactTokenizer(WordPieceVocab.build(tiny_corpus, max_size=512), max_length=32)


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsa, "interpret", True)


@pytest.fixture(scope="module")
def jax_model(tiny_tokenizer):
    jc = dataclasses.replace(JaxConfig.tiny(vocab_size=len(tiny_tokenizer.vocab), impact_activation="softplus"),
                             dtype="float32")
    return JaxDeepImpact(jc, tiny_tokenizer, seed=0)


@pytest.fixture
def models(jax_model, port_tokenizer):
    """(JAX model, port model with its weights, port config).  The JAX model
    is a shallow copy, so a JAX trainer rebinding its params leaves the
    module's model as it was."""
    tc = dataclasses.replace(EncoderConfig.tiny(vocab_size=len(port_tokenizer.vocab),
                                                impact_activation="softplus"), dtype="float32")
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jax_model.params), tc)
    return copy.copy(jax_model), DeepImpact(tc, port_tokenizer, state_dict=sd, device="cpu"), tc


def _items(loss):
    return DISTIL if loss in ("distil_kl", "distil_mse") else TRIPLES


def _collated(tok, collates, loss, max_length):
    return collates[loss](_items(loss), tok, max_length)


def _torch_batch(arrays):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items() if k != "group_size"}


def _port_grads(model):
    return {n: p.grad.clone() for n, p in model.module.named_parameters()}


# -- losses ------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["pairwise_ce", "distil_mse", "distil_kl", "distil_kl_1d",
                                  "distil_kl_zero_prob"])
def test_losses_match_jax(case):
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((5, 4)).astype(np.float32) * 3
    teacher = rng.standard_normal((5, 4)).astype(np.float32) * 3
    if case == "distil_kl_1d":
        scores, teacher = scores[0], teacher[0]
    if case == "distil_kl_zero_prob":
        teacher[1, 2] = -1e4  # softmax underflows to an exact 0: the 0 * log 0 guard
    name = "distil_kl" if case.startswith("distil_kl") else case
    args = (scores,) if name == "pairwise_ce" else (scores, teacher)
    want = float(jlosses.LOSSES[name](*(jnp.asarray(a) for a in args)))
    got = losses.LOSSES[name](*(torch.from_numpy(a) for a in args))
    assert got.dtype == torch.float32 and np.isfinite(float(got))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# -- collates, packing, loader, datasets ---------------------------------------------


@pytest.mark.parametrize("loss", ["pairwise_ce", "distil_kl", "in_batch_negatives"])
def test_collates_and_packing_match_jax(tiny_tokenizer, port_tokenizer, loss):
    want = _collated(tiny_tokenizer, JAX_COLLATES, loss, 32)
    got = _collated(port_tokenizer, COLLATES, loss, 32)
    assert got.keys() == want.keys() and got["group_size"] == want["group_size"]
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    if loss not in packed.PACKABLE_LOSSES:
        with pytest.raises(ValueError, match="per \\(query, document\\)"):
            packed.pack_collated(got)
        return
    pw, pg = jpacked.pack_collated(want, 1), packed.pack_collated(got)
    assert pg.keys() == pw.keys()
    for k in pw:
        assert np.array_equal(pg[k], pw[k]) and np.asarray(pg[k]).dtype == np.asarray(pw[k]).dtype, k
    for n in (1, 5, 16, 17, 100, 256):
        assert packed.row_buckets(n) == jpacked.row_buckets(n, 1)


def test_unported_collates_raise(tiny_tokenizer, port_tokenizer):
    """The cross-encoder and pairwise-impact collates run and give the JAX
    arrays; neither loss packs."""
    for name in ("cross_encoder", "pairwise_impact"):
        want = JAX_COLLATES[name](TRIPLES, tiny_tokenizer, 32)
        got = COLLATES[name](TRIPLES, port_tokenizer, 32)
        assert got.keys() == want.keys() and got["group_size"] == want["group_size"] == 2
        for k in want:
            assert np.array_equal(got[k], want[k]) and np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert name not in packed.PACKABLE_LOSSES


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_loader_order_matches_jax(seed):
    items = list(range(23))
    for drop_last in (True, False):
        kw = dict(batch_size=4, collate_fn=list, shuffle=True, seed=seed, drop_last=drop_last)
        ours, theirs = BatchLoader(items, **kw), JaxLoader(items, **kw)
        assert len(ours) == len(theirs)
        for epoch in (0, 1):
            assert list(ours.epoch(epoch)) == list(theirs.epoch(epoch))


def test_batch_loader_stops_its_producer_when_closed():
    """A run that ends at total_steps closes the epoch early: the producer
    thread must end with it rather than block on a full queue."""
    before = threading.active_count()
    batches = BatchLoader(list(range(100)), 2, list, shuffle=False).epoch(0)
    assert next(batches) == [0, 1]
    batches.close()
    assert threading.active_count() == before


def test_batch_loader_raises_collate_errors():
    def collate(batch):
        raise ValueError("bad row")

    with pytest.raises(ValueError, match="bad row"):
        list(BatchLoader(list(range(4)), 2, collate).epoch(0))


def test_training_datasets_match_jax(tmp_path):
    (tmp_path / "c.tsv").write_text("".join(f"p{i}\tpassage {i}\n" for i in range(8)))
    (tmp_path / "q.tsv").write_text("".join(f"q{i}\tquery {i}\n" for i in range(3)))
    (tmp_path / "t.tsv").write_text("q0\tp1\tp2\nq1\tp3\tp4\nq2\tp0\tp7\n")
    (tmp_path / "t5.tsv").write_text("q0\tp1\tp2\t9.5\t1.25\nq2\tp0\tp7\t3\t-2\n")
    (tmp_path / "qrels.tsv").write_text("q0\t0\tp1\t1\nq1\t0\tp3\t1\n")
    scores = {"q0": {f"p{i}": float(i) for i in range(7)}, "q1": {"p3": 2.0, "p4": 1.0, "p5": 0.5},
              "q2": {"p0": np.float32(1.5), "p6": 0.25}}
    with gzip.open(tmp_path / "s.pkl.gz", "wb") as f:
        pickle.dump(scores, f)
    paths = [tmp_path / "q.tsv", tmp_path / "c.tsv"]
    pairs = [
        (tds.MSMarcoTriples(tmp_path / "t.tsv", *paths), jds.MSMarcoTriples(tmp_path / "t.tsv", *paths)),
        (tds.DistilHardNegatives(tmp_path / "t5.tsv", *paths),
         jds.DistilHardNegatives(tmp_path / "t5.tsv", *paths)),
        (tds.DistillationScores(tmp_path / "s.pkl.gz", *paths, batch_size=2),
         jds.DistillationScores(tmp_path / "s.pkl.gz", *paths, batch_size=2)),
        (tds.DistillationScores(tmp_path / "s.pkl.gz", *paths, batch_size=2, qrels_path=tmp_path / "qrels.tsv"),
         jds.DistillationScores(tmp_path / "s.pkl.gz", *paths, batch_size=2, qrels_path=tmp_path / "qrels.tsv")),
    ]
    for ours, theirs in pairs:
        assert len(ours) == len(theirs) > 0
        assert [ours[i] for i in range(len(ours))] == [theirs[i] for i in range(len(theirs))]
    c = tds.Collection(tmp_path / "c.tsv", offset=2, limit=3)
    assert list(c) == list(jds.Collection(tmp_path / "c.tsv", offset=2, limit=3))
    assert [list(b) for b in c.batch_iter(2)] == [[("p2", "passage 2"), ("p3", "passage 3")],
                                                   [("p4", "passage 4")]]
    with gzip.open(tmp_path / "evil.pkl.gz", "wb") as f:
        pickle.dump({"q0": collections.OrderedDict(p0=1.0)}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tds.DistillationScores(tmp_path / "evil.pkl.gz", *paths)


# -- loss and gradients ----------------------------------------------------------------

_GRAD_CASES = [("pairwise_ce", False), ("pairwise_ce", True), ("distil_kl", False),
               ("distil_kl", True), ("distil_mse", False), ("distil_mse", True),
               ("in_batch_negatives", False)]


@pytest.mark.parametrize("max_length", [32, 128])
@pytest.mark.parametrize("loss,pack", _GRAD_CASES)
def test_loss_and_grads_match_jax(tiny_tokenizer, port_tokenizer, models, loss, pack, max_length):
    jm, tm, tc = models
    want_arrays = _collated(tiny_tokenizer, JAX_COLLATES, loss, max_length)
    got_arrays = _collated(port_tokenizer, COLLATES, loss, max_length)
    if pack:
        want_arrays, got_arrays = jpacked.pack_collated(want_arrays), packed.pack_collated(got_arrays)
        assert "segment_ids" in got_arrays
    jl, jg = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm.module, loss)))(
        jm.params, {k: v for k, v in want_arrays.items() if k != "group_size"})
    want_grads = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jg), tc)

    tl = make_loss_fn(tm.module, loss, use_kernels=False)(_torch_batch(got_arrays))
    tl.backward()
    tl = float(tl.detach())
    got_grads = _port_grads(tm)
    assert got_grads.keys() == want_grads.keys()
    if max_length == 32:
        np.testing.assert_allclose(tl, float(jl), rtol=1e-5)
        for name, w in want_grads.items():
            np.testing.assert_allclose(got_grads[name].numpy(), w.numpy(), rtol=2e-4, atol=1e-6,
                                       err_msg=name)
    else:
        np.testing.assert_allclose(tl, float(jl), rtol=1e-4)
        for name, w in want_grads.items():
            err = float((got_grads[name] - w).abs().max())
            scale = float(w.abs().max())
            if name.endswith("attention.key.bias"):
                # softmax is shift-invariant along each query's row, so this
                # gradient is exactly 0 in exact arithmetic: both sides hold
                # the bf16 recompute's rounding, which scales with the key
                # weights' gradient
                scale = float(want_grads[name.replace(".bias", ".weight")].abs().max())
            assert err <= 1e-2 * scale, (name, err, scale)


# -- optimizer, accumulation, resume -------------------------------------------------------


def _jax_grads(jm, loss, batches):
    fn = jax.jit(jax.value_and_grad(jax_make_loss_fn(jm.module, loss)))
    return [fn(jm.params, {k: v for k, v in b.items() if k != "group_size"}) for b in batches]


def _to_port(grads, tc, model):
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, grads), tc)
    return [sd[n].clone() for n, _ in model.module.named_parameters()]


def _assert_params_equal(jm, tm, tc, rtol=1e-5, atol=1e-7):
    want = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jm.params), tc)
    for name, p in tm.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_clipped_adamw_matches_optax(tiny_tokenizer, models, tmp_path):
    """Three optimizer steps on the same gradients, of global norm 0.5, 10
    (clipped to 2) and 2 (at the threshold)."""
    jm, tm, tc = models
    cfg = dict(batch_size=4, lr=1e-3, save_every=10**6, eval_every=10**9)
    jt = JaxTrainer(jm, JaxTrainConfig(**cfg), tmp_path / "jax")
    tt = Trainer(tm, TrainConfig(**cfg), tmp_path / "port")
    (_, g), = _jax_grads(jm, "pairwise_ce", [_collated(tiny_tokenizer, JAX_COLLATES, "pairwise_ce", 32)])
    norm = float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g))))
    for target in (0.5, 10.0, 2.0):
        step = jax.tree_util.tree_map(lambda x: x * np.float32(target / norm), g)
        jt.params, jt.opt_state = jt._apply_grads(jt.params, jt.opt_state, step)
        jm.params = jt.params
        tt._apply_grads(_to_port(step, tc, tm))
        _assert_params_equal(jm, tm, tc)


def _inject(jt, tt, jm, tc, tm, grads):
    """Both trainers take the same gradients in turn, whatever the batch."""
    jax_iter, port_iter = iter(grads), iter(grads)

    def jax_step(params, batch):
        loss, g = next(jax_iter)
        norm = jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)))
        return (loss, norm), g

    def port_step(batch):
        loss, g = next(port_iter)
        gs = _to_port(g, tc, tm)
        return torch.tensor(float(loss)), torch.linalg.vector_norm(torch.stack([x.norm() for x in gs])), gs

    jt._grad_step, tt._grad_step = jax_step, port_step


def test_accumulation_with_trailing_window_matches_jax(tiny_tokenizer, models, tmp_path):
    """accum=2 over 3 micro-batches: one full window and a trailing window
    of one, rescaled by accum/window; manager.step counts 2 optimizer steps."""
    jm, tm, tc = models
    loader = JaxLoader(TRIPLES * 2, 2, lambda b: JAX_COLLATES["pairwise_ce"](b, tiny_tokenizer, 32),
                       shuffle=False)
    batches = list(loader)[:3]
    grads = _jax_grads(jm, "pairwise_ce", batches)
    grads = [(l, jax.tree_util.tree_map(lambda x, s=s: x * np.float32(s), g))
             for (l, g), s in zip(grads, (3.0, 0.5, 40.0))]  # the last window clips
    cfg = dict(batch_size=2, lr=1e-3, save_every=10**6, eval_every=10**9, grad_accumulation_steps=2)
    jt = JaxTrainer(jm, JaxTrainConfig(**cfg), tmp_path / "jax")
    tt = Trainer(tm, TrainConfig(**cfg), tmp_path / "port")
    _inject(jt, tt, jm, tc, tm, grads)
    jt.train(batches, total_steps=3)
    tt.train(batches, total_steps=3)
    assert jt.manager.step == tt.manager.step == 2
    _assert_params_equal(jm, tm, tc)
    assert (tmp_path / "port" / "DeepImpact_final.pt").exists()


def _port_model(port_tokenizer, seed=0):
    cfg = dataclasses.replace(EncoderConfig.tiny(vocab_size=len(port_tokenizer.vocab)), dtype="float32")
    return DeepImpact(cfg, port_tokenizer, seed=seed, device="cpu")


def _port_batches(port_tokenizer, n=6):
    loader = BatchLoader(TRIPLES * 3, 2, lambda b: COLLATES["pairwise_ce"](b, port_tokenizer, 32),
                         shuffle=False)
    return list(loader)[:n]


def test_resume_with_skip_replay_equals_unbroken_run(port_tokenizer, tmp_path):
    """accum=2: 4 batches, a checkpoint, a fresh trainer resumes (skip 4) and
    takes the rest: the params of the unbroken 6-batch run.  A resume at a
    doubled batch size rescales the step (reference trainer.py:63-66)."""
    batches = _port_batches(port_tokenizer)
    cfg = TrainConfig(batch_size=2, lr=1e-3, save_every=1, eval_every=10**9,
                      grad_accumulation_steps=2)
    m1 = _port_model(port_tokenizer)
    t1 = Trainer(m1, cfg, tmp_path / "unbroken")
    t1.train(batches)
    assert t1.manager.step == 3

    Trainer(_port_model(port_tokenizer), cfg, tmp_path / "split").train(batches[:4])
    m3 = _port_model(port_tokenizer)
    t3 = Trainer(m3, cfg, tmp_path / "split")
    skip = t3.maybe_resume()
    assert skip == 4
    t3.train(batches, skip=skip)
    assert t3.manager.step == 3
    for a, b in zip(m1.module.parameters(), m3.module.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)

    t4 = Trainer(_port_model(port_tokenizer), dataclasses.replace(cfg, batch_size=4), tmp_path / "split")
    assert t4.maybe_resume() == (3 * 2 // 4) * 2


def test_losses_decrease_on_the_port(port_tokenizer, tmp_path):
    for loss in ("pairwise_ce", "distil_kl", "distil_mse", "in_batch_negatives"):
        items = DISTIL if loss.startswith("distil") else TRIPLES
        loader = BatchLoader(items * 4, 2, lambda b, loss=loss: COLLATES[loss](b, port_tokenizer, 32),
                             shuffle=False)
        batches = list(loader)
        model = _port_model(port_tokenizer)
        trainer = Trainer(model, TrainConfig(batch_size=2, lr=1e-3, save_every=10**6, eval_every=10**9,
                                             loss=loss), tmp_path / loss)
        first = float(trainer.loss_fn(trainer._put_batch(batches[0])))
        trainer.train(batches, total_steps=8)
        last = float(trainer.loss_fn(trainer._put_batch(batches[0])))
        assert np.isfinite(first) and last < first, loss


# -- checkpoints and the eval record ----------------------------------------------------------


def test_checkpoint_names_and_meta_match_jax(port_tokenizer, tmp_path):
    """The same on_step sequence through both managers leaves the same
    snapshots (suffixes latest/<step>/best/final) and the same sidecars."""
    model = _port_model(port_tokenizer)
    params = {"w": jnp.ones(3)}
    jmgr = JaxManager(tmp_path / "jax", name="DeepImpact", save_every=2, save_best=True, batch_size=8)
    tmgr = CheckpointManager(tmp_path / "port", name="DeepImpact", save_every=2, save_best=True,
                             batch_size=8)
    opt = torch.optim.AdamW(model.module.parameters(), lr=1e-3)
    for metric in (3.0, 1.0, 2.0, 0.5, 4.0):
        jmgr.on_step(params, {"m": jnp.zeros(3)}, metric=metric)
        tmgr.on_step(model.module.state_dict(), opt.state_dict(), metric=metric)
    jmgr.save("final", params)
    tmgr.save("final", model.module.state_dict())

    def listing(d, ext):
        return sorted(p.name.replace(ext, "") for p in d.iterdir())

    assert listing(tmp_path / "port", ".pt") == listing(tmp_path / "jax", ".msgpack")
    for meta in (tmp_path / "jax").glob("*.meta.json"):
        assert json.loads(meta.read_text()) == json.loads((tmp_path / "port" / meta.name).read_text())
    # a snapshot feeds the index CLI's --checkpoint: the payload unwraps
    loaded = load_params(tmp_path / "port" / "DeepImpact_4.pt")
    assert loaded.keys() == model.module.state_dict().keys()
    restored = CheckpointManager(tmp_path / "port", name="DeepImpact").load()
    assert restored["step"] == 4 and restored["opt_state"] is not None
    final = CheckpointManager(tmp_path / "port", name="DeepImpact").load("final")
    assert final["opt_state"] is None
    model.save(tmp_path / "m.pt")
    again = DeepImpact.load(model.config, port_tokenizer, tmp_path / "m.pt", device="cpu")
    for a, b in zip(model.module.parameters(), again.module.parameters()):
        assert torch.equal(a, b)
    save_params(tmp_path / "bare.pt", {"x": torch.ones(2)})
    assert torch.equal(load_params(tmp_path / "bare.pt")["x"], torch.ones(2))
    # a JAX snapshot reads back through core.flax_msgpack; mapping its tree
    # onto the port's state dict needs the model's config
    from improving_learned_index_tpu_torch.core import flax_msgpack

    jax_final = flax_msgpack.read(tmp_path / "jax" / "DeepImpact_final.msgpack")
    assert list(jax_final) == ["params"] and np.array_equal(jax_final["params"]["w"], np.ones(3))
    with pytest.raises(ValueError, match="EncoderConfig"):
        load_params(tmp_path / "jax" / "DeepImpact_final.msgpack")


def test_eval_stall_seconds_logged(port_tokenizer, tmp_path):
    class _Ev:
        calls = 0

        def evaluate_all(self, model):
            _Ev.calls += 1
            return {"avg": ({"NDCG@10": 1.0},) * 4}

    trainer = Trainer(_port_model(port_tokenizer),
                      TrainConfig(batch_size=2, lr=1e-3, save_every=10**6, eval_every=2),
                      tmp_path, evaluator=_Ev())
    trainer.train(_port_batches(port_tokenizer), total_steps=4)
    records = [json.loads(line) for line in (tmp_path / "metrics.txt").read_text().splitlines()]
    evals = [r for r in records if "eval_stall_seconds" in r]
    assert _Ev.calls == 2 and [r["iteration"] for r in evals] == [0, 2]
    assert all(r["eval_stall_seconds"] >= 0 for r in evals)


def test_profiling_hooks_write_traces(tmp_path, monkeypatch):
    """trace() writes a chrome trace on the CPU; annotate() names a region
    in it, and with no profiler running never enters record_function."""
    from improving_learned_index_tpu_torch.core.profiling import annotate, trace

    with trace(tmp_path / "one"):
        with annotate("region/x"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "region/x" in (tmp_path / "one" / "trace.json").read_text()
    with trace(tmp_path / "off", enabled=False):
        pass
    assert not (tmp_path / "off").exists()

    entered = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: entered.append(name))
    first, second = annotate("region/y"), annotate("region/z")
    with first:
        with second:
            torch.ones(8).sum()
    assert entered == [] and first is second
