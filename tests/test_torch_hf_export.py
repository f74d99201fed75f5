"""The port's HF-layout export (``models.hf_import.port_deep_impact_to_hf``)
against the JAX package's ``flax_deep_impact_to_hf``.

The tiny config's JAX params are carried into the port with
``flax_params_to_port``; both exports must give the same keys and
bit-equal float32 arrays (both are re-layouts in fp32, no arithmetic), and
the export read back by ``hf_deep_impact_to_port`` must give the port's
state dict bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.models.encoder import DeepImpactModel as JaxModel
from improving_learned_index_tpu.models.encoder import init_params
from improving_learned_index_tpu.models.hf_import import flax_deep_impact_to_hf
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models import (
    DeepImpactModel,
    flax_params_to_port,
    hf_deep_impact_to_port,
    port_deep_impact_to_hf,
)

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
            max_position_embeddings=256, hidden_dropout=0.0, attention_dropout=0.0)


@pytest.fixture(scope="module")
def params():
    jc = JaxConfig(**TINY)
    return jax.tree_util.tree_map(np.asarray, init_params(JaxModel(jc), jc, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("trunk_prefix", ["bert.", "roberta."])
def test_export_matches_jax(params, trunk_prefix):
    tc = EncoderConfig(**TINY)
    want = flax_deep_impact_to_hf(params, JaxConfig(**TINY), trunk_prefix=trunk_prefix)
    got = port_deep_impact_to_hf(flax_params_to_port(params, tc), tc, trunk_prefix=trunk_prefix)
    assert got.keys() == want.keys()
    assert "impact_score_encoder.0.weight" in got and got["impact_score_encoder.0.bias"].shape == (1,)
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, np.ndarray) and g.dtype == np.float32 and g.flags.c_contiguous, key
        assert g.shape == w.shape and np.array_equal(g, w), key


@pytest.mark.parametrize("trunk_prefix", ["bert.", "roberta."])
def test_round_trip_is_bit_exact(params, trunk_prefix):
    tc = EncoderConfig(**TINY)
    sd = flax_params_to_port(params, tc)
    back = hf_deep_impact_to_port(port_deep_impact_to_hf(sd, tc, trunk_prefix=trunk_prefix), tc)
    assert back.keys() == sd.keys() == DeepImpactModel(tc).state_dict().keys()
    for key in sd:
        assert back[key].dtype == torch.float32 and torch.equal(back[key], sd[key]), key


def test_trained_module_state_dict_and_head_key(params):
    """A module's own ``state_dict`` (a trained model's) exports, with a
    custom head key, and reads back into a module that scores the same."""
    tc = EncoderConfig(**TINY)
    model = DeepImpactModel(tc)
    model.load_state_dict(flax_params_to_port(params, tc))
    hf = port_deep_impact_to_hf(model.state_dict(), tc, head_key="head.0")
    assert "head.0.weight" in hf and not any(k.startswith("impact_score_encoder") for k in hf)
    other = DeepImpactModel(tc)
    other.load_state_dict(hf_deep_impact_to_port(hf, tc, head_key="head.0"))
    ids = torch.from_numpy(np.random.default_rng(0).integers(2, 128, (2, 24)))
    mask = torch.ones_like(ids)
    with torch.no_grad():
        a = model(ids, mask, torch.zeros_like(ids))
        b = other(ids, mask, torch.zeros_like(ids))
    assert torch.equal(a, b)
