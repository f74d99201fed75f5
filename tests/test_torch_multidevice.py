"""The port's data-parallel encode, ``DeepImpact(devices=["cpu"] * 3)``,
against the JAX ``DeepImpact(mesh=)`` on the suite's 8 virtual CPU devices
and against the port's single-device route, on the same fp32 weights
(``flax_params_to_port``): identical term lists and impacts within the JAX
data-parallel test's tolerance (tests/test_model_api.py, rtol = atol =
2e-5), unpacked and packed.  Then the port's multi-device dry run on
``["cpu"] * 2``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.core.config import MeshConfig
from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
from improving_learned_index_tpu.parallel.mesh import make_mesh
from improving_learned_index_tpu.text import ImpactTokenizer as JaxTokenizer
from improving_learned_index_tpu.text import WordPieceVocab as JaxVocab
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models import DeepImpact, flax_params_to_port
from improving_learned_index_tpu_torch.parallel import dryrun_multidevice
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

TOL = dict(rtol=2e-5, atol=2e-5)
WORDS = ("the quick brown fox jumps over lazy dog neural networks learn sparse representations "
         "of text inverted indexes map terms to document postings impact scores quantize").split()


def _corpus(n, seed=0):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=int(rng.integers(2, 14)))) for _ in range(n)]


@pytest.fixture(scope="module")
def models(cpu_devices):
    """JAX single and 8-device models, the port's single and 3-replica
    models, all on one set of fp32 tiny weights."""
    corpus = _corpus(60)
    jv = JaxVocab.build(corpus, max_size=512)
    tv = WordPieceVocab(jv.id_to_token)
    fields = dataclasses.asdict(JaxConfig.tiny(vocab_size=len(jv)))
    fields["dtype"] = "float32"
    jc, tc = JaxConfig(**fields), EncoderConfig(**fields)
    jtok, ttok = JaxTokenizer(jv, max_length=32), ImpactTokenizer(tv, max_length=32)
    jax_single = JaxDeepImpact(jc, jtok, seed=0)
    jax_mesh = JaxDeepImpact(jc, jtok, params=jax_single.params,
                             mesh=make_mesh(MeshConfig(data=8, model=1)))
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jax_single.params), tc)
    single = DeepImpact(tc, ttok, state_dict=sd, device="cpu")
    replicas = DeepImpact(tc, ttok, state_dict=sd, devices=["cpu"] * 3)
    return corpus, jax_mesh, single, replicas


def test_replicas_share_one_module_per_device(models):
    _, _, single, replicas = models
    assert replicas.devices == [replicas.device] * 3 and replicas.device.type == "cpu"
    assert list(replicas._replicas) == [replicas.device]
    assert replicas._replicas[replicas.device][0] is replicas.module
    assert not replicas.use_kernels


@pytest.mark.parametrize("n_docs", [11, 2, 1])
def test_data_parallel_encode_equals_jax_mesh_and_single(models, n_docs):
    """Unpacked: 11 rows split 4/3/4, and fewer rows than devices."""
    corpus, jax_mesh, single, replicas = models
    docs = corpus[:n_docs]
    encs = [replicas.process_document(d) for d in docs]
    jencs = [jax_mesh.process_document(d) for d in docs]
    got, terms = replicas.encode_term_scores(encs, max_terms=16)
    want, jterms = jax_mesh.encode_term_scores(jencs, max_terms=16)
    one, one_terms = single.encode_term_scores(encs, max_terms=16)
    assert terms == jterms == one_terms
    assert got.shape == want.shape == one.shape == (n_docs, 16)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, one, **TOL)


def test_data_parallel_packed_encode_equals_jax_mesh_and_single(models):
    """Packed, 8 rows a batch (the JAX mesh's data axis divides it): the
    flat slots index the gathered [R, S] output of the three parts."""
    corpus, jax_mesh, single, replicas = models
    got = replicas.get_impact_scores_batch_packed(corpus, rows=8)
    want = jax_mesh.get_impact_scores_batch_packed(corpus, rows=8)
    one = single.get_impact_scores_batch_packed(corpus, rows=8)
    assert len(got) == len(want) == len(one) == len(corpus)
    for g, w, o in zip(got, want, one):
        assert [t for t, _ in g] == [t for t, _ in w] == [t for t, _ in o]
        np.testing.assert_allclose([v for _, v in g], [v for _, v in w], **TOL)
        np.testing.assert_allclose([v for _, v in g], [v for _, v in o], **TOL)


def test_devices_argument_checks():
    vocab = WordPieceVocab.build(["a b c"], max_size=32)
    tok = ImpactTokenizer(vocab, max_length=32)
    cfg = EncoderConfig.tiny(vocab_size=len(vocab))
    with pytest.raises(ValueError, match="at least one"):
        DeepImpact(cfg, tok, devices=[])
    with pytest.raises(ValueError, match="not both"):
        DeepImpact(cfg, tok, device="cpu", devices=["cpu", "cpu"])
    assert DeepImpact(cfg, tok, devices=["cpu", "cpu"]).devices == [DeepImpact(
        cfg, tok, device="cpu").device] * 2


def _two_module_model(single):
    """A model over ``["cpu", "cpu:0"]``: two distinct devices, so the
    second part runs on a real replica (a copy of the module)."""
    model = DeepImpact(single.config, single.tokenizer, state_dict=single.module.state_dict(),
                       devices=["cpu", "cpu:0"])
    assert len(model._replicas) == 2
    assert model._replicas[torch.device("cpu:0")][0] is not model.module
    return model


def test_real_replica_equals_jax_mesh_and_single(models):
    """The second part on a copy of the module, gathered with the first:
    unpacked (11 rows split 6/5) and packed, as the one-module routes."""
    corpus, jax_mesh, single, _ = models
    model = _two_module_model(single)
    encs = [model.process_document(d) for d in corpus[:11]]
    got, terms = model.encode_term_scores(encs, max_terms=16)
    want, jterms = jax_mesh.encode_term_scores([jax_mesh.process_document(d) for d in corpus[:11]],
                                               max_terms=16)
    one, _ = single.encode_term_scores(encs, max_terms=16)
    assert terms == jterms
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, one, **TOL)
    packed = model.get_impact_scores_batch_packed(corpus, rows=8)
    packed_one = single.get_impact_scores_batch_packed(corpus, rows=8)
    assert [[t for t, _ in d] for d in packed] == [[t for t, _ in d] for d in packed_one]
    np.testing.assert_allclose([v for d in packed for _, v in d], [v for d in packed_one for _, v in d], **TOL)


def test_replica_follows_training_and_reloaded_weights(models, tmp_path):
    """A training step, then ``load_state_dict`` of the first weights: each
    encode after it equals a one-module model on the module's weights
    (every part, so the replica took the change)."""
    from improving_learned_index_tpu_torch.core.config import TrainConfig
    from improving_learned_index_tpu_torch.train.trainer import Trainer

    corpus, _, single, _ = models
    model = _two_module_model(single)
    first = {k: v.clone() for k, v in model.module.state_dict().items()}
    encs = [model.process_document(d) for d in corpus[:8]]
    rng = np.random.default_rng(3)
    groups, group, seq = 2, 3, 16
    batch = {
        "input_ids": rng.integers(1, single.config.vocab_size, (groups * group, seq)).astype(np.int32),
        "attention_mask": np.ones((groups * group, seq), np.int32),
        "type_ids": np.zeros((groups * group, seq), np.int32),
        "masks": (rng.random((groups * group, seq)) < 0.3).astype(np.float32),
        "scores": rng.random((groups, group)).astype(np.float32),
    }
    cfg = TrainConfig(batch_size=groups, lr=1e-2, loss="distil_kl", group_size=group,
                      save_every=10**9, save_best=False)
    Trainer(model, cfg, tmp_path).train([batch], total_steps=1)
    trained = DeepImpact(single.config, single.tokenizer, state_dict=model.module.state_dict(), device="cpu")
    got = model.encode_term_scores(encs, max_terms=16)[0]
    np.testing.assert_allclose(got, trained.encode_term_scores(encs, max_terms=16)[0], **TOL)
    assert not np.allclose(got, single.encode_term_scores(encs, max_terms=16)[0], **TOL)
    model.module.load_state_dict(first)
    np.testing.assert_allclose(model.encode_term_scores(encs, max_terms=16)[0],
                               single.encode_term_scores(encs, max_terms=16)[0], **TOL)


def test_dryrun_multidevice_on_two_cpu_devices():
    out = dryrun_multidevice(["cpu"] * 2)
    assert out["devices"] == ["cpu", "cpu"] and np.isfinite(out["loss"])
    assert out["postings"] > 0 and out["tile_shard_docs"] % 65536 == 0
