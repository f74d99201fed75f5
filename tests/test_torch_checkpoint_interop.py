"""The JAX package's flax msgpack checkpoints in the port.

- ``core.flax_msgpack`` decodes what ``flax.serialization.to_bytes`` writes
  (fp32, bf16, int32, numpy scalars, nested trees, an optax AdamW state, a
  leaf chunked past a lowered ``MAX_CHUNK_SIZE``) to the leaves
  ``msgpack_restore`` gives, bit for bit (bf16 as a ``torch.bfloat16``
  tensor of the same bits), and writes the same bytes as ``to_bytes``.
- A JAX ``CheckpointManager`` snapshot of a tiny ``DeepImpact`` (params and
  an optax AdamW state after one update) loads into the port: at fp32 and
  S=96 (the plain attention route on both sides) the impacts are within
  2e-5 of the JAX model's, ``tests/test_torch_encoder.py``'s fp32
  tolerance; ``cli.index --checkpoint`` on it gives the JAX CLI's terms,
  impacts within that file's bf16 tolerance, 0.05.
- A truncated file raises; a training resume from a msgpack snapshot
  raises, naming the optimizer state.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from improving_learned_index_tpu.core.checkpoint import CheckpointManager as JaxManager
from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu_torch.core import flax_msgpack
from improving_learned_index_tpu_torch.core.checkpoint import load_params
from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
from improving_learned_index_tpu_torch.models import DeepImpact
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

CORPUS = ["the quick brown fox jumps over the lazy dog", "a fast auburn fox leaped across a canine",
          "neural networks learn sparse representations", "inverted indexes map terms to postings",
          "impact scores quantize term importance", "the dog sleeps while the fox runs"]


def _numpy_tree(x):
    """A tree's jax arrays as numpy, dict order kept (``jax.device_get``
    sorts dict keys)."""
    if isinstance(x, dict):
        return {k: _numpy_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_numpy_tree(v) for v in x)
    if hasattr(x, "_fields"):
        return type(x)(*(_numpy_tree(v) for v in x))
    return np.asarray(x) if isinstance(x, jax.Array) else x


def _trees():
    rng = np.random.default_rng(0)
    params = {"dense": {"kernel": rng.standard_normal((8, 4)).astype(np.float32),
                        "bias": np.zeros(4, np.float32)},
              "emb": {"embedding": rng.standard_normal((16, 8)).astype(np.float32)}}
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, weight_decay=0.01))
    opt = tx.init(jax.tree_util.tree_map(jnp.asarray, params))
    grads = jax.tree_util.tree_map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), params)
    _, opt = tx.update(grads, opt, jax.tree_util.tree_map(jnp.asarray, params))
    return {
        "fp32": {"w": rng.standard_normal((3, 5)).astype(np.float32), "e": np.zeros((0, 2), np.float32)},
        "bf16": {"w": np.asarray(jnp.asarray(rng.standard_normal((4, 6)), jnp.bfloat16)),
                 "s": np.array(1.5, dtype=jnp.bfloat16)[()]},
        "int32": {"ids": np.arange(-5, 1000, 7, dtype=np.int32), "u8": np.arange(7, dtype=np.uint8)},
        "scalars": {"f32": np.float32(2.5), "i64": np.int64(-9), "f64": np.float64(3.25),
                    "py": 3, "neg": -100000, "big": 2**40, "f": 1.5, "none": None, "t": True,
                    "s": "naïve", "c": 1 + 2j},
        "nested": {"a": {"b": {"c": np.ones((2, 2), np.float16)}}, "l": [np.arange(3), (4, "x")],
                   "k" * 40: {str(i): np.float32(i) for i in range(20)}},
        "adamw": {"params": params, "opt_state": _numpy_tree(opt)},
    }


def _assert_same(ref, got, path=""):
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(ref) == list(got), path
        for k in ref:
            _assert_same(ref[k], got[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16, path
        assert tuple(got.shape) == np.shape(ref), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(ref).view(np.int16))
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        np.testing.assert_array_equal(got, ref)
    else:
        assert type(got) is type(ref) and got == ref, (path, got, ref)


@pytest.mark.parametrize("name", ["fp32", "bf16", "int32", "scalars", "nested", "adamw"])
def test_decode_and_write_match_flax(name):
    tree = _trees()[name]
    data = serialization.to_bytes(tree)
    _assert_same(serialization.msgpack_restore(data), flax_msgpack.read_bytes(data))
    assert flax_msgpack.write_bytes(tree) == data


def test_chunked_leaf(monkeypatch, tmp_path):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((10, 7)).astype(np.float32),
            "bf": np.asarray(jnp.asarray(rng.standard_normal(50), jnp.bfloat16)),
            "small": np.arange(4, dtype=np.int32)}
    data = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    (tmp_path / "c.msgpack").write_bytes(data)
    _assert_same(serialization.msgpack_restore(data), flax_msgpack.read(tmp_path / "c.msgpack"))
    assert flax_msgpack.write_bytes(tree, max_chunk_size=64) == data


def test_truncated_and_corrupt_files_raise(tmp_path):
    data = serialization.to_bytes(_trees()["adamw"])
    for cut in (1, len(data) // 2, len(data) - 1):
        with pytest.raises(ValueError, match="truncated"):
            flax_msgpack.read_bytes(data[:cut])
    with pytest.raises(ValueError, match="extra data"):
        flax_msgpack.read_bytes(data + b"\x00")
    (tmp_path / "DeepImpact_cut.msgpack").write_bytes(data[: len(data) // 3])
    with pytest.raises(ValueError, match="truncated"):
        load_params(tmp_path / "DeepImpact_cut.msgpack", EncoderConfig.tiny())


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """A JAX ``CheckpointManager`` snapshot of a tiny fp32 DeepImpact (its
    params and AdamW state after one update), and the JAX model."""
    d = tmp_path_factory.mktemp("ckpt")
    vocab = JaxVocab.build(CORPUS, max_size=512)
    vocab.save(d / "vocab.txt")
    cfg = dataclasses.replace(JaxConfig.tiny(vocab_size=len(vocab), impact_activation="softplus"),
                              dtype="float32")
    model = JaxDeepImpact(cfg, JaxTokenizer(vocab, max_length=96), seed=5)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(1e-3, weight_decay=0.01))
    opt = tx.init(model.params)
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 1e-3, p.dtype), model.params)
    updates, opt = tx.update(grads, opt, model.params)
    model.params = optax.apply_updates(model.params, updates)
    manager = JaxManager(d / "ck", name="DeepImpact", save_every=1, batch_size=4)
    manager.on_step(model.params, opt, metric=0.5)
    return d, model


def test_manager_snapshot_forward_matches_jax(snapshot):
    d, jax_model = snapshot
    path = d / "ck" / "DeepImpact_latest.msgpack"
    assert path.exists() and (d / "ck" / "DeepImpact_1.msgpack").exists()
    cfg = dataclasses.replace(EncoderConfig.tiny(vocab_size=jax_model.config.vocab_size,
                                                 impact_activation="softplus"), dtype="float32")
    tok = ImpactTokenizer(WordPieceVocab.load(d / "vocab.txt"), max_length=96)
    sd = load_params(path, cfg)
    assert set(sd) == set(DeepImpact(cfg, tok, device="cpu").module.state_dict())
    for model in (DeepImpact(cfg, tok, state_dict=sd, device="cpu"),
                  DeepImpact.load(cfg, tok, path, device="cpu")):
        got = model.get_impact_scores_batch(CORPUS)
        want = jax_model.get_impact_scores_batch(CORPUS)
        for g, w in zip(got, want):
            assert [t for t, _ in g] == [t for t, _ in w]
            np.testing.assert_allclose([v for _, v in g], [v for _, v in w], atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="EncoderConfig"):
        load_params(path)


def test_cli_index_from_manager_snapshot(tmp_path, snapshot):
    from improving_learned_index_tpu.cli.index import main as jax_index_main
    from improving_learned_index_tpu.index.forward_index import parse_line
    from improving_learned_index_tpu_torch.cli.index import main as index_main

    d, _ = snapshot
    (tmp_path / "c.tsv").write_text("".join(f"{i}\t{t}\n" for i, t in enumerate(CORPUS)))
    common = ["--collection_path", str(tmp_path / "c.tsv"), "--vocab_path", str(d / "vocab.txt"),
              "--tiny", "--model_kind", "xlmr", "--max_length", "64", "--model_batch_size", "4",
              "--checkpoint", str(d / "ck" / "DeepImpact_latest.msgpack")]
    assert jax_index_main(common + ["--output_file_path", str(tmp_path / "jax.txt")]) == 0
    assert index_main(common + ["--output_file_path", str(tmp_path / "port.txt"), "--device", "cpu"]) == 0
    want = [parse_line(l) for l in (tmp_path / "jax.txt").read_text().splitlines()]
    got = [parse_line(l) for l in (tmp_path / "port.txt").read_text().splitlines()]
    assert len(got) == len(want) == len(CORPUS)
    for g, w in zip(got, want):
        assert list(g) == list(w) and all(v > 0 for v in g.values())
        assert max(abs(g[t] - w[t]) for t in w) <= 0.05


def test_msgpack_resume_raises(tmp_path, snapshot):
    import shutil

    from improving_learned_index_tpu_torch.train import Trainer

    d, jax_model = snapshot
    ck = tmp_path / "ck"
    ck.mkdir()
    shutil.copy(d / "ck" / "DeepImpact_latest.msgpack", ck)
    cfg = EncoderConfig.tiny(vocab_size=jax_model.config.vocab_size)
    model = DeepImpact(cfg, ImpactTokenizer(WordPieceVocab.load(d / "vocab.txt"), max_length=64),
                       device="cpu")
    trainer = Trainer(model, TrainConfig(batch_size=4), ck)
    assert trainer.manager.exists()
    with pytest.raises(ValueError, match="optax AdamW state"):
        trainer.maybe_resume()
