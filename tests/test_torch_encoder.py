"""The port's encoder against the flax encoder, with weights carried across by
``flax_params_to_port``; the weight importers against the JAX package's.

Geometry: hidden 64, 2 layers, 4 heads (head dim 16), max positions 256.
The JAX side runs its Pallas attention in interpret mode wherever S=128
selects it, as the port runs its kernel's plain version there.

Tolerances (largest |impact| is ~1.7 here):
- fp32, S=96 (the plain attention route on both sides, all fp32): 2e-5,
  summation order only;
- fp32, S=128 (the short-attention route: both round q, k, v and the
  probabilities to bf16 inside attention): 2e-3, a bf16 rounding that the
  fp32 noise moves by one ulp;
- bf16 throughout: 0.05, bf16 roundings at other places in XLA and torch
  compound over the layers.
"""

import jax
import numpy as np
import pytest
import torch

import improving_learned_index_tpu.ops.short_attention as jsa
from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.models.encoder import DeepImpactModel as JaxModel
from improving_learned_index_tpu.models.encoder import init_params
from improving_learned_index_tpu.models.encoder import make_packed_position_ids as jax_packed_pos
from improving_learned_index_tpu.models.encoder import make_position_ids as jax_pos
from improving_learned_index_tpu.models.hf_import import (
    flax_deep_impact_to_hf,
    hf_deep_impact_to_flax,
)
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models import (
    DeepImpactModel,
    flax_params_to_port,
    hf_deep_impact_to_port,
    load_hf_checkpoint,
)
from improving_learned_index_tpu_torch.models.encoder import (
    make_packed_position_ids,
    make_position_ids,
)

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            max_position_embeddings=256, hidden_dropout=0.0, attention_dropout=0.0)
ROBERTA = dict(position_offset=2, pad_token_id=1, type_vocab_size=1, layer_norm_eps=1e-5,
               impact_activation="softplus")


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsa, "interpret", True)


def _models(**kw):
    fields = dict(TINY, **kw)
    jc, tc = JaxConfig(**fields), EncoderConfig(**fields)
    jm = JaxModel(jc)
    params = init_params(jm, jc, jax.random.PRNGKey(0))
    tm = DeepImpactModel(tc)
    tm.load_state_dict(flax_params_to_port(jax.tree_util.tree_map(np.asarray, params), tc))
    return jm, params, tm.eval(), tc


def _batch(seq, pad_id, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 128, (3, seq)).astype(np.int32)
    mask = np.ones((3, seq), np.int32)
    mask[0, 90:] = 0
    mask[2, 50:] = 0
    ids[mask == 0] = pad_id
    seg = np.zeros((3, seq), np.int32)
    seg[0, :40], seg[0, 40:90] = 1, 2
    seg[1, :] = 1
    seg[2, :7], seg[2, 7:60], seg[2, 60:seq - 9] = 1, 2, 3
    ids_p = ids.copy()
    ids_p[seg == 0] = pad_id
    return ids, mask, ids_p, seg


def _run_both(jm, params, tm, ids, mask, seg=None):
    ty = np.zeros_like(ids)
    want = np.asarray(jm.apply({"params": params}, ids, mask, ty, segment_ids=seg))[..., 0]
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(ty),
                 segment_ids=None if seg is None else torch.from_numpy(seg))
    assert got.dtype == torch.float32 and got.shape == (*ids.shape, 1)
    return got[..., 0].numpy(), want


@pytest.mark.parametrize("family", ["bert", "roberta"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seq,dtype,tol", [
    (96, "float32", 2e-5),
    (128, "float32", 2e-3),
    (128, "bfloat16", 0.05),
])
def test_encoder_matches_flax(family, packed, seq, dtype, tol):
    kw = dict(dtype=dtype, **(ROBERTA if family == "roberta" else {}))
    jm, params, tm, tc = _models(**kw)
    ids, mask, ids_p, seg = _batch(seq, tc.pad_token_id)
    if packed:
        got, want = _run_both(jm, params, tm, ids_p, (seg > 0).astype(np.int32), seg)
        real = seg > 0
    else:
        got, want = _run_both(jm, params, tm, ids, mask)
        real = mask.astype(bool)
    assert np.isfinite(got[real]).all()
    np.testing.assert_allclose(got[real], want[real], rtol=0, atol=tol)


@pytest.mark.parametrize("family", ["bert", "roberta"])
def test_position_ids_match_jax(family):
    kw = ROBERTA if family == "roberta" else {}
    jc, tc = JaxConfig(**TINY, **kw), EncoderConfig(**TINY, **kw)
    ids, _, ids_p, seg = _batch(128, tc.pad_token_id)
    assert np.array_equal(make_position_ids(torch.from_numpy(ids), tc).numpy(),
                          np.asarray(jax_pos(ids, jc)))
    assert np.array_equal(make_packed_position_ids(torch.from_numpy(seg), tc).numpy(),
                          np.asarray(jax_packed_pos(seg, jc)))


def test_packed_rows_equal_unpacked_documents():
    """The port alone: a document packed into a row scores as it does alone
    (block-diagonal attention and restarted positions), fp32."""
    _, _, tm, tc = _models(dtype="float32")
    rng = np.random.default_rng(5)
    docs = [rng.integers(2, 128, n).astype(np.int32) for n in (30, 50, 40)]
    s = 128
    alone = []
    for d in docs:
        ids = np.zeros((1, s), np.int32)
        ids[0, : len(d)] = d
        with torch.no_grad():
            alone.append(tm(torch.from_numpy(ids), torch.from_numpy((ids > 0).astype(np.int32)))[0, : len(d), 0])
    ids = np.zeros((1, s), np.int32)
    seg = np.zeros((1, s), np.int32)
    ids[0, :120] = np.concatenate(docs)
    seg[0, :30], seg[0, 30:80], seg[0, 80:120] = 1, 2, 3
    with torch.no_grad():
        packed = tm(torch.from_numpy(ids), torch.from_numpy((seg > 0).astype(np.int32)),
                    segment_ids=torch.from_numpy(seg))[0, :, 0]
    torch.testing.assert_close(torch.cat(alone), packed[:120], rtol=0, atol=2e-3)


def test_hf_import_equals_flax_carry():
    """hf_deep_impact_to_port(flax_deep_impact_to_hf(params)) carries exactly
    the tensors that flax_params_to_port carries."""
    _, params, _, tc = _models()
    hf = flax_deep_impact_to_hf(params, JaxConfig(**TINY))
    a = hf_deep_impact_to_port(hf, tc)
    b = flax_params_to_port(jax.tree_util.tree_map(np.asarray, params), tc)
    assert a.keys() == b.keys() == DeepImpactModel(tc).state_dict().keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def test_seeded_head_and_local_checkpoint_match_jax(tmp_path):
    """Without head keys the head is JAX's seeded numpy draw; a local
    pytorch_model.bin loads to what the JAX route gives (trunk weights and
    the seeded head), and a directory without it raises."""
    _, params, _, tc = _models()
    hf = flax_deep_impact_to_hf(params, JaxConfig(**TINY))
    trunk = {k: v for k, v in hf.items() if not k.startswith("impact_score_encoder")}
    want = flax_params_to_port(hf_deep_impact_to_flax(trunk, JaxConfig(**TINY)), tc)
    got = hf_deep_impact_to_port(trunk, tc)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    torch.save({k: torch.from_numpy(v) for k, v in hf.items()}, tmp_path / "pytorch_model.bin")
    loaded = load_hf_checkpoint(tmp_path, tc)
    for key in want:
        assert torch.equal(loaded[key], want[key]), key
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="pytorch_model.bin"):
        load_hf_checkpoint(tmp_path / "empty", tc)


def test_kernel_route_selection_matches_jax():
    """The port takes the short-attention route exactly where the JAX
    package does: use_short_attention off means the plain route, equal to
    flax with its kernel off (fp32, tight)."""
    jm, params, tm, tc = _models(dtype="float32", use_short_attention=False)
    ids, mask, _, _ = _batch(128, tc.pad_token_id)
    got, want = _run_both(jm, params, tm, ids, mask)
    real = mask.astype(bool)
    np.testing.assert_allclose(got[real], want[real], rtol=0, atol=2e-5)
