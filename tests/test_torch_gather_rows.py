"""Port's ``accumulate_rows`` (heavy-term stage) against the JAX package's
Pallas kernel, run through the Pallas interpreter on the CPU.

Cells and sums are integers, so every comparison is exact.  The CUDA kernel
itself is held to the plain version on the card, in test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from improving_learned_index_tpu.ops.gather_rows import accumulate_rows as jax_accumulate_rows
from improving_learned_index_tpu_torch.ops import gather_rows as gr

TILE = 1 << 16


def _tables(rng, nq, t_heavy, n_hit, pairs_list, h_b=64, p_b=64):
    hit = np.sort(rng.choice(t_heavy, n_hit, replace=False)).astype(np.int32)
    ids = np.zeros(h_b, np.int32)
    ids[:n_hit] = hit
    pairs = np.zeros((p_b, 2), np.int32)
    pairs[: len(pairs_list)] = pairs_list
    counts = np.array([n_hit, len(pairs_list)], np.int32)
    return ids, pairs, counts


def _run_both(dense, ids, pairs, counts, nq):
    want = np.asarray(
        jax_accumulate_rows(
            jnp.asarray(dense, dtype=jnp.bfloat16),
            jnp.asarray(ids), jnp.asarray(pairs), jnp.asarray(counts), nq,
            interpret=True,
        )
    )
    got = gr.accumulate_rows(
        torch.from_numpy(dense).to(torch.bfloat16),
        torch.from_numpy(ids), torch.from_numpy(pairs), torch.from_numpy(counts), nq,
    )
    return want, got.numpy()


@pytest.mark.parametrize(
    "case",
    ["shared_and_duplicate_pairs", "zero_counts", "bf16_cells_up_to_256", "full_batch"],
)
def test_accumulate_rows_matches_jax_interpret(case):
    rng = np.random.default_rng(1)
    nq, t_heavy = 8, 37
    if case == "shared_and_duplicate_pairs":
        # slot 1 shared by queries 0 and 1; (5, 3) repeated = a repeated term
        pl = [(0, 0), (0, 1), (1, 1), (2, 5), (3, 8), (5, 2), (5, 3), (5, 3), (5, 4)]
        dense = rng.integers(0, 256, (t_heavy, TILE)).astype(np.float32)
        ids, pairs, counts = _tables(rng, nq, t_heavy, 9, pl)
    elif case == "zero_counts":
        dense = np.ones((4, TILE), np.float32)
        ids, pairs = np.zeros(64, np.int32), np.zeros((64, 2), np.int32)
        counts = np.zeros(2, np.int32)
    elif case == "bf16_cells_up_to_256":
        dense = np.full((t_heavy, TILE), 256.0, np.float32)
        dense[:, ::3] = rng.integers(0, 257, (t_heavy, len(range(0, TILE, 3))))
        pl = [(q, s) for q in range(nq) for s in range(4)]
        ids, pairs, counts = _tables(rng, nq, t_heavy, 4, pl)
    else:  # 64 queries, 3 pairs each over 40 hit rows, 2 strips
        nq = 64
        dense = rng.integers(0, 256, (t_heavy + 20, 2 * TILE)).astype(np.float32)
        pl = [(q, int(s)) for q in range(nq) for s in rng.integers(0, 40, 3)]
        ids, pairs, counts = _tables(rng, nq, t_heavy + 20, 40, pl, p_b=256)
    want, got = _run_both(dense, ids, pairs, counts, nq)
    np.testing.assert_array_equal(got, want)


def test_accumulate_rows_fp32_rows_match_numpy():
    """fp32 dense rows (the duplicate-posting rebuild) with cells past the
    bf16-exact range; pairs in no particular order."""
    rng = np.random.default_rng(2)
    nq, t_heavy, n_pad = 5, 11, 1280
    dense = rng.integers(0, 5000, (t_heavy, n_pad)).astype(np.float32)
    ids = np.array([3, 7, 1, 0], np.int32)
    pl = [(4, 0), (0, 2), (4, 0), (2, 3), (0, 1)]
    pairs = np.array(pl + [(0, 0)] * 3, np.int32)
    counts = np.array([4, len(pl)], np.int32)
    got = gr.accumulate_rows(
        torch.from_numpy(dense), torch.from_numpy(ids), torch.from_numpy(pairs),
        torch.from_numpy(counts), nq,
    )
    want = np.zeros((nq, n_pad), np.float32)
    for q, s in pl:
        want[q] += dense[ids[s]]
    np.testing.assert_array_equal(got.numpy(), want)


def test_pair_tables_group_live_pairs_by_query():
    """The kernel's inputs: each live pair's dense row grouped by query, and
    per-query ranges; dead pairs (past counts[1]) are dropped."""
    ids = torch.tensor([10, 20, 30], dtype=torch.int32)
    pairs = torch.tensor([[2, 0], [0, 1], [2, 2], [0, 0], [1, 1], [0, 2]], dtype=torch.int32)
    counts = torch.tensor([3, 5], dtype=torch.int32)  # last pair is dead
    rows, qptr = gr.pair_tables(ids, pairs, counts, 4)
    assert qptr.tolist() == [0, 2, 3, 5, 5]
    assert rows[:5].tolist() == [20, 10, 20, 10, 30]
