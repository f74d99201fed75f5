"""The port's ``AsyncCheckpointManager`` against the JAX package's
``OrbaxCheckpointManager`` on the same ``on_step`` sequence: the same
snapshot stems (``.pt`` files where orbax writes directories), the same
``.meta.json``, best metric and step rescale; its copy semantics, its
writer's errors, and a ``Trainer`` with it in place of the synchronous
manager writing the synchronous manager's files."""

import json

import numpy as np
import pytest
import torch

pytest.importorskip("orbax.checkpoint")

import jax.numpy as jnp  # noqa: E402

from improving_learned_index_tpu.core.orbax_checkpoint import OrbaxCheckpointManager  # noqa: E402
from improving_learned_index_tpu_torch.core import async_checkpoint  # noqa: E402
from improving_learned_index_tpu_torch.core.async_checkpoint import AsyncCheckpointManager  # noqa: E402
from improving_learned_index_tpu_torch.core.checkpoint import load_params  # noqa: E402

METRICS = [2.0, 1.0, 3.0, 0.5, 0.7, 0.25]


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"dense": {"kernel": rng.standard_normal((8, 4)).astype(np.float32),
                      "bias": np.zeros(4, np.float32)},
            "emb": rng.standard_normal((16, 8)).astype(np.float32)}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(v.copy()) for k, v in tree.items()}


def _files(d, suffix):
    stems = sorted(p.name[: -len(suffix)] if suffix and p.name.endswith(suffix) else p.name
                   for p in d.iterdir() if not p.name.endswith(".meta.json"))
    metas = {p.name: json.loads(p.read_text()) for p in d.iterdir() if p.name.endswith(".meta.json")}
    return stems, metas


@pytest.fixture(scope="module")
def orbax_run(tmp_path_factory):
    """The JAX manager over the sequence: (files, best, rescaled step)."""
    d = tmp_path_factory.mktemp("orbax")
    mgr = OrbaxCheckpointManager(d, name="M", save_every=2, save_best=True, batch_size=4)
    for i, metric in enumerate(METRICS):
        tree = {k: (jnp.asarray(v) if not isinstance(v, dict) else {a: jnp.asarray(b) for a, b in v.items()})
                for k, v in _tree(i).items()}
        mgr.on_step(tree, {"mu": tree} if i % 2 else None, metric=metric)
    mgr.save("final", {"emb": jnp.asarray(_tree(9)["emb"])})
    mgr.wait()
    assert mgr.exists()
    return _files(d, ""), mgr.best_metric, mgr.rescale_step_for_batch(8)


def test_on_step_sequence_matches_orbax(tmp_path, orbax_run):
    (want_stems, want_meta), want_best, want_step = orbax_run
    mgr = AsyncCheckpointManager(tmp_path, name="M", save_every=2, save_best=True, batch_size=4)
    states = {}
    for i, metric in enumerate(METRICS):
        params = _torch(_tree(i))
        mgr.on_step(params, {"mu": params} if i % 2 else None, metric=metric)
        states[i + 1] = _tree(i)
    mgr.save("final", {"emb": torch.from_numpy(_tree(9)["emb"])})
    mgr.wait()
    assert mgr.exists()
    stems, metas = _files(tmp_path, ".pt")
    assert stems == want_stems
    assert metas == want_meta
    assert mgr.best_metric == want_best
    # every snapshot holds the state of its on_step
    for name, meta in metas.items():
        suffix = name[len("M_"): -len(".meta.json")]
        restored = mgr.load(suffix)
        if suffix == "final":
            np.testing.assert_array_equal(restored["params"]["emb"].numpy(), _tree(9)["emb"])
            continue
        want = states[meta["step"]]
        np.testing.assert_array_equal(restored["params"]["dense"]["kernel"].numpy(), want["dense"]["kernel"])
        assert (restored["opt_state"] is not None) == meta["has_opt_state"]
        assert restored["step"] == meta["step"] and restored["batch_size"] == 4
    mgr2 = AsyncCheckpointManager(tmp_path, name="M", save_every=2)
    mgr2.load()
    assert mgr2.rescale_step_for_batch(8) == want_step
    assert load_params(tmp_path / "M_latest.pt")["emb"].shape == (16, 8)


def test_change_after_on_step_does_not_reach_snapshot(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path, name="M", save_every=1)
    params = {"w": torch.arange(6, dtype=torch.float32)}
    opt = {"state": {0: {"step": torch.tensor(1.0), "exp_avg": torch.ones(6)}}, "param_groups": [{"lr": 0.1}]}
    mgr.on_step(params, opt)
    params["w"].add_(100.0)  # an optimizer step, in place, while the writer runs
    opt["state"][0]["step"] += 1
    opt["state"][0]["exp_avg"].mul_(0)
    mgr.on_step(params, opt)
    mgr.wait()
    first = torch.load(tmp_path / "M_1.pt", weights_only=True)
    assert torch.equal(first["params"]["w"], torch.arange(6, dtype=torch.float32))
    assert float(first["opt_state"]["state"][0]["step"]) == 1.0
    assert torch.equal(first["opt_state"]["state"][0]["exp_avg"], torch.ones(6))
    second = torch.load(tmp_path / "M_2.pt", weights_only=True)
    assert torch.equal(second["params"]["w"], torch.arange(6, dtype=torch.float32) + 100)
    assert json.loads((tmp_path / "M_latest.meta.json").read_text())["step"] == 2


def test_writer_error_surfaces(tmp_path, monkeypatch):
    def broken(path, payload):
        raise OSError("disk full")

    monkeypatch.setattr(async_checkpoint, "_write", broken)
    mgr = AsyncCheckpointManager(tmp_path, name="M", save_every=1)
    mgr.on_step({"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # raised once
    mgr.on_step({"w": torch.ones(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.on_step({"w": torch.ones(2)})  # the next save joins the failed one
    assert not (tmp_path / "M_1.meta.json").exists()  # no meta without its payload
    assert not mgr.exists()


def test_trainer_with_async_manager_writes_sync_files(tmp_path, tiny_corpus):
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.train import COLLATES, Trainer

    tok = ImpactTokenizer(WordPieceVocab.build(tiny_corpus, max_size=512), max_length=32)
    docs = tiny_corpus
    triples = [(" ".join(docs[i].split()[:2]), docs[i], docs[(i + 3) % len(docs)]) for i in range(len(docs))]
    batches = [COLLATES["pairwise_ce"](triples[j:j + 2], tok, 32) for j in range(0, 8, 2)] * 2
    out = {}
    for name in ("sync", "async"):
        model = DeepImpact(EncoderConfig.tiny(vocab_size=len(tok.vocab)), tok, seed=1, device="cpu")
        cfg = TrainConfig(batch_size=2, save_every=3, save_best=True)
        trainer = Trainer(model, cfg, tmp_path / name)
        if name == "async":
            m = trainer.manager
            trainer.manager = AsyncCheckpointManager(m.checkpoint_dir, name=m.name, save_every=m.save_every,
                                                     save_best=m.save_best, batch_size=m.batch_size)
        trainer.train(batches)
        if name == "async":
            trainer.manager.wait()
        out[name] = _files(tmp_path / name, ".pt")
    assert out["sync"] == out["async"]
    stems = out["sync"][0]
    assert {"DeepImpact_3", "DeepImpact_6", "DeepImpact_latest", "DeepImpact_final"} <= set(stems)
    for stem in stems:
        a = torch.load(tmp_path / "sync" / f"{stem}.pt", weights_only=True)
        b = torch.load(tmp_path / "async" / f"{stem}.pt", weights_only=True)
        assert list(a["params"]) == list(b["params"])
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), (stem, k)
        assert a["opt_state"]["param_groups"] == b["opt_state"]["param_groups"]
        for i, st in a["opt_state"]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, b["opt_state"]["state"][i][k]), (stem, i, k)


def test_snapshots_under_thread_switching(tmp_path):
    """Many saves with the state changed in place between them and the
    interpreter switching threads often: every snapshot holds its own
    step's state, and the writer is joined at the end."""
    import sys

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        mgr = AsyncCheckpointManager(tmp_path, name="M", save_every=1)
        params = {"w": torch.zeros(64, 64), "b": torch.zeros(64)}
        for step in range(1, 25):
            params["w"].fill_(step)
            params["b"].fill_(-step)
            mgr.on_step(params, {"state": {0: {"step": torch.tensor(float(step))}}})
        mgr.wait()
        assert mgr._thread is None
    finally:
        sys.setswitchinterval(interval)
    for step in range(1, 25):
        snap = torch.load(tmp_path / f"M_{step}.pt", weights_only=True)
        assert bool((snap["params"]["w"] == step).all()) and bool((snap["params"]["b"] == -step).all())
        assert float(snap["opt_state"]["state"][0]["step"]) == step
        assert json.loads((tmp_path / f"M_{step}.meta.json").read_text())["step"] == step
    assert json.loads((tmp_path / "M_latest.meta.json").read_text())["step"] == 24
