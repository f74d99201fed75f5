"""Port's ``exact_topk_integer`` against the JAX package's: values AND doc
ids, rank by rank (boundary ties in doc-id order), exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from improving_learned_index_tpu.ops.exact_topk import exact_topk_integer as jax_topk
from improving_learned_index_tpu_torch.ops.exact_topk import exact_topk_integer


def _scores(case, rng):
    if case == "boundary_ties":  # few distinct values: k cuts through a tie run
        return rng.integers(0, 6, (5, 3000)), 100
    if case == "k_ge_n":
        return rng.integers(0, 50, (3, 300)), 1000
    if case == "all_zero_rows":
        s = rng.integers(0, 40, (4, 2048))
        s[[0, 2]] = 0
        return s, 64
    if case == "width_not_multiple_of_256":
        return rng.integers(0, 2000, (6, 3001)), 250
    if case == "k_is_1":
        s = rng.integers(0, 30, (4, 777))
        s[1, [5, 9]] = 99  # tie for the top: doc 5 wins
        return s, 1
    if case == "sparse_rows":  # fewer positives than k
        s = np.zeros((3, 1000))
        s[:, rng.integers(0, 1000, 20)] = rng.integers(1, 500, 20)
        return s, 50
    return rng.integers(0, 4000, (8, 65536)), 1000  # wide


@pytest.mark.parametrize(
    "case",
    ["boundary_ties", "k_ge_n", "all_zero_rows", "width_not_multiple_of_256",
     "k_is_1", "sparse_rows", "wide"],
)
def test_exact_topk_matches_jax(case):
    scores, k = _scores(case, np.random.default_rng(3))
    scores = scores.astype(np.float32)
    v_j, i_j = (np.asarray(a) for a in jax_topk(jnp.asarray(scores), k))
    v_t, i_t = exact_topk_integer(torch.from_numpy(scores), k)
    np.testing.assert_array_equal(v_t.numpy(), v_j)
    np.testing.assert_array_equal(i_t.numpy(), i_j)
    assert i_t.dtype == torch.int32

    # and the contract itself: a stable sort by (score desc, doc asc)
    order = np.lexsort((np.broadcast_to(np.arange(scores.shape[1]), scores.shape), -scores))
    kk = min(k, scores.shape[1])
    ref_v = np.take_along_axis(scores, order, 1)[:, :kk]
    ref_i = np.where(ref_v > 0, order[:, :kk], 0)
    np.testing.assert_array_equal(v_t.numpy(), ref_v)
    np.testing.assert_array_equal(i_t.numpy(), ref_i)
