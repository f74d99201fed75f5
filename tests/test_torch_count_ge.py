"""Port's ``count_ge`` (on the CPU: its plain version) against the JAX
package's Pallas kernel in interpret mode, and the port's
``exact_topk_integer`` through the plain count on a sliced
(non-contiguous) score matrix against the JAX top-k.  Integer counts and
integer scores: every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from improving_learned_index_tpu.ops.count_ge import _TILE, count_ge as jax_count_ge
from improving_learned_index_tpu.ops.exact_topk import exact_topk_integer as jax_topk
from improving_learned_index_tpu_torch.ops import plain_versions
from improving_learned_index_tpu_torch.ops.count_ge import count_ge, count_ge_plain
from improving_learned_index_tpu_torch.ops.exact_topk import exact_topk_integer


@pytest.mark.parametrize("n_thresh", [1, 7, 128])
def test_count_ge_matches_jax_interpret(n_thresh):
    """[8, 2 * 16384] as in tests/test_pallas_engine_kernels.py, with one,
    the search's 7 and the most (128) thresholds a row."""
    rng = np.random.default_rng(2)
    q, n = 8, 2 * _TILE
    scores = rng.integers(0, 2000, (q, n)).astype(np.float32)
    t = rng.integers(1, 2000, (q, n_thresh)).astype(np.float32)
    want = np.asarray(jax_count_ge(jnp.asarray(scores), jnp.asarray(t), interpret=True))
    for fn in (count_ge, count_ge_plain):
        got = fn(torch.from_numpy(scores), torch.from_numpy(t))
        assert got.dtype == torch.int32 and got.shape == (q, n_thresh)
        np.testing.assert_array_equal(got.numpy(), want)


def test_count_ge_any_width_and_stride():
    """No N % 16384 gate: an odd width, read through a sliced view of a
    wider matrix, equals the numpy count."""
    rng = np.random.default_rng(4)
    wide = torch.from_numpy(rng.integers(0, 50, (5, 1001)).astype(np.float32))
    view = wide[:, :777]
    assert not view.is_contiguous()
    t = torch.from_numpy(rng.integers(0, 50, (5, 7)).astype(np.float32))
    want = (view.numpy()[:, :, None] >= t.numpy()[:, None, :]).sum(axis=1)
    np.testing.assert_array_equal(count_ge(view, t).numpy(), want)


@pytest.mark.parametrize("bad", ["t_rows", "t_zero", "t_over", "dtype"])
def test_count_ge_rejects_bad_inputs(bad):
    s = torch.zeros(4, 100)
    t = {"t_rows": torch.zeros(3, 7), "t_zero": torch.zeros(4, 0),
         "t_over": torch.zeros(4, 129), "dtype": torch.zeros(4, 7, dtype=torch.float64)}[bad]
    with pytest.raises(ValueError):
        count_ge(s, t)


@pytest.mark.parametrize("k", [1, 100, 1000])
def test_exact_topk_sliced_input_matches_jax(k):
    """The hybrid engine hands the top-k a sliced [:, :num_docs] view when
    the padded width is not a whole number of 256-doc blocks."""
    rng = np.random.default_rng(5)
    full = np.zeros((6, 3200), np.float32)
    full[:, :3001] = rng.integers(0, 40, (6, 3001))
    full[2] = 0  # a row with no positives
    view = torch.from_numpy(full)[:, :3001]
    assert not view.is_contiguous()
    v_j, i_j = (np.asarray(a) for a in jax_topk(jnp.asarray(full[:, :3001]), k))
    with plain_versions():
        v_t, i_t = exact_topk_integer(view, k)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    # outside the switch the CPU runs the plain versions too
    v_n, i_n = exact_topk_integer(view, k)
    assert torch.equal(v_n, v_t) and torch.equal(i_n, i_t)

