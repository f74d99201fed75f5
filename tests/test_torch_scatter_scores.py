"""Port's ``apply_tail_updates`` (tail stage) against the JAX package's
Pallas kernel, run through the Pallas interpreter on the CPU.

Impacts are integers 1..255, so every comparison is exact.  The port
updates ``scores`` in place; the JAX function returns a new array.  The
CUDA kernel itself is held to the plain version on the card, in
test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from improving_learned_index_tpu.ops.scatter_scores import PAGE, TILE
from improving_learned_index_tpu.ops.scatter_scores import (
    apply_tail_updates as jax_apply_tail_updates,
)
from improving_learned_index_tpu_torch.ops import scatter_scores as ss


def _case(name, rng):
    if name == "random_with_padding":
        nq, n_pad, e = 16, 2 * TILE, 3000
        d = rng.integers(0, n_pad, e)
        v = rng.integers(1, 256, e)
        r = rng.integers(0, nq, e)
        scores = rng.integers(0, 300, (nq, n_pad))
        pad = 4 * PAGE - e  # v == 0 marks padding
        d, v, r = (np.concatenate([a, np.zeros(pad, a.dtype)]) for a in (d, v, r))
    elif name == "duplicates":
        nq, n_pad = 8, TILE
        d = np.array([0, 0, 0, TILE - 1, TILE - 1] + [5] * (PAGE - 5))
        v = np.full(PAGE, 3)
        r = np.zeros(PAGE, np.int64)
        scores = np.zeros((nq, n_pad))
    elif name == "all_padding":
        nq, n_pad = 8, TILE
        d, v, r = np.zeros(PAGE), np.zeros(PAGE), np.zeros(PAGE)
        scores = np.arange(nq * n_pad).reshape(nq, n_pad) % 7
    else:  # last tile, with updates straddling the tile boundary
        nq, n_pad, e = 4, 3 * TILE, 2 * PAGE
        d = np.concatenate([
            rng.integers(2 * TILE - 64, 2 * TILE, e // 2),
            rng.integers(2 * TILE, 2 * TILE + 64, e // 2),
        ])
        v = rng.integers(1, 256, e)
        r = rng.integers(0, nq, e)
        scores = np.zeros((nq, n_pad))
    return (scores.astype(np.float32), d.astype(np.int32), v.astype(np.float32),
            r.astype(np.int32))


@pytest.mark.parametrize(
    "name", ["random_with_padding", "duplicates", "all_padding", "last_tile_straddle"]
)
def test_apply_tail_updates_matches_jax_interpret(name):
    scores, d, v, r = _case(name, np.random.default_rng(4))
    want = np.asarray(
        jax_apply_tail_updates(
            jnp.asarray(scores), jnp.asarray(d), jnp.asarray(v), jnp.asarray(r),
            interpret=True,
        )
    )
    s = torch.from_numpy(scores.copy())
    got = ss.apply_tail_updates(s, torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(r))
    assert got is s  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_tail_updates_any_length_matches_numpy():
    """The port takes any update count (no 1024-update pages) and any n_pad."""
    rng = np.random.default_rng(5)
    nq, n_pad, e = 3, 1280, 777
    d = rng.integers(0, n_pad, e).astype(np.int32)
    v = rng.integers(0, 256, e).astype(np.float32)  # some zeros: padding
    r = rng.integers(0, nq, e).astype(np.int32)
    want = np.zeros((nq, n_pad), np.float32)
    np.add.at(want, (r, d), v)
    got = ss.apply_tail_updates(
        torch.zeros(nq, n_pad), torch.from_numpy(d), torch.from_numpy(v), torch.from_numpy(r)
    )
    np.testing.assert_array_equal(got.numpy(), want)
