"""Port's heavy-term stage against the JAX package's Pallas kernel, run
through the Pallas interpreter on the CPU: ``accumulate_rows`` (the JAX
signature) and ``accumulate_grouped`` over the pair table, built on the host
(``group_pairs``, the engines' route) or from the JAX layout
(``pair_tables``, ``accumulate_rows``' route on the card).

Cells and sums are integers, so those comparisons are exact; float rows are
held within 4 x 2^-23 of each cell's sum of |terms|.  The CUDA kernel itself
is held to the plain versions on the card, in test_torch_kernels_cuda.py.
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
    dense, ids, pairs, counts, nq = _jax_case(case)
    want, got = _run_both(dense, ids, pairs, counts, nq)
    np.testing.assert_array_equal(got, want)


def _jax_case(case):
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
    return dense, ids, pairs, counts, nq


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
    """The kernel's table from the JAX layout: each live pair's slot grouped
    by query (ascending within it), per-query ranges, the hit rows; dead
    pairs (past counts[1]) are dropped."""
    ids = torch.tensor([10, 20, 30], dtype=torch.int32)
    pairs = torch.tensor([[2, 0], [0, 1], [2, 2], [0, 0], [1, 1], [0, 2]], dtype=torch.int32)
    counts = torch.tensor([3, 5], dtype=torch.int32)  # last pair is dead
    table = gr.pair_tables(ids, pairs, counts, 4)
    qptr, hits, _ = _unpack(table.numpy(), 4)
    assert qptr.tolist() == [0, 2, 3, 5, 5]
    assert hits.tolist() == [10, 20, 30]
    assert _rows_by_query(table.numpy(), 4) == [[10, 20], [20], [10, 30], []]


def _unpack(table, nq):
    """(qptr, hits, slots) of a pair table."""
    h = int(table[0])
    return table[1 : nq + 2], table[nq + 2 : nq + 2 + h], table[nq + 2 + h :]


def _rows_by_query(table, nq):
    qptr, hits, slots = _unpack(table, nq)
    return [hits[slots[qptr[q] : qptr[q + 1]]].tolist() for q in range(nq)]


def _builder_case(case):
    """(ids, pairs, counts, nq, t_heavy) in the JAX layout: ids in random
    order, pairs in random order."""
    rng = np.random.default_rng(sum(map(ord, case)))
    nq, t_heavy, n_hit, n_pairs, n_dead = 8, 50, 20, 60, 0
    if case == "nq_over_64":
        nq, n_pairs = 300, 900
    elif case == "hit_rows_over_256":
        nq, t_heavy, n_hit, n_pairs = 64, 1000, 400, 1200
    elif case == "dead_pairs":
        n_dead = 13
    ids = rng.choice(t_heavy, n_hit, replace=False).astype(np.int32)
    q = rng.integers(0, nq, n_pairs)
    if case == "queries_without_pairs":
        q = rng.choice([0, 3, 7], n_pairs)
    pairs = np.stack([q, rng.integers(0, n_hit, n_pairs)], 1).astype(np.int32)
    if case == "duplicates":
        pairs = np.concatenate([pairs, pairs[:25], pairs[:5]])
        pairs = pairs[rng.permutation(len(pairs))]
    counts = np.array([n_hit, len(pairs)], np.int32)
    if n_dead:  # garbage past counts[1]
        dead = np.stack([rng.integers(-3, nq + 5, n_dead), rng.integers(-3, 10**6, n_dead)], 1)
        pairs = np.concatenate([pairs, dead.astype(np.int32)])
    return ids, pairs, counts, nq, t_heavy


@pytest.mark.parametrize(
    "case",
    ["random_order", "duplicates", "dead_pairs", "queries_without_pairs", "nq_over_64",
     "hit_rows_over_256"],
)
def test_group_pairs_equals_pair_tables_and_numpy(case):
    """The host builder against the JAX-layout builder and a numpy
    reference: the same query ranges, the same rows a query (the host's
    ascending), unique ascending hit rows; both tables give the JAX-layout
    plain version's scores."""
    ids, pairs, counts, nq, t_heavy = _builder_case(case)
    live = pairs[: counts[1]]
    pair_q, pair_rows = live[:, 0], ids[live[:, 1]]
    host = gr.group_pairs(pair_q, pair_rows, nq)
    ids_t, pairs_t, counts_t = (torch.from_numpy(a) for a in (ids, pairs, counts))
    dev = gr.pair_tables(ids_t, pairs_t, counts_t, nq).numpy()
    assert host.dtype == np.int32 and dev.dtype == np.int32
    want_rows = [sorted(pair_rows[pair_q == q].tolist()) for q in range(nq)]
    want_qptr = np.concatenate([[0], np.cumsum([len(r) for r in want_rows])])
    np.testing.assert_array_equal(_unpack(host, nq)[0], want_qptr)
    np.testing.assert_array_equal(_unpack(dev, nq)[0], want_qptr)
    np.testing.assert_array_equal(_unpack(host, nq)[1], np.unique(pair_rows))
    assert _rows_by_query(host, nq) == want_rows
    assert [sorted(r) for r in _rows_by_query(dev, nq)] == want_rows
    if case == "queries_without_pairs":
        assert sum(1 for r in want_rows if not r) == nq - 3
    dense = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (t_heavy, 96)).astype(np.float32))
    want = gr.accumulate_rows_plain(dense, ids_t, pairs_t, counts_t, nq)
    assert torch.equal(gr.accumulate_grouped(dense, torch.from_numpy(host), nq), want)
    assert torch.equal(gr.accumulate_grouped_plain(dense, torch.from_numpy(dev), nq), want)


@pytest.mark.parametrize(
    "case",
    ["shared_and_duplicate_pairs", "zero_counts", "bf16_cells_up_to_256", "full_batch"],
)
def test_accumulate_grouped_matches_jax_interpret(case):
    """``accumulate_grouped``'s plain version over both builders' tables
    equals the JAX kernel: the engines' route (host table) and
    ``accumulate_rows``' route on the card (``pair_tables``)."""
    dense, ids, pairs, counts, nq = _jax_case(case)
    want, _ = _run_both(dense, ids, pairs, counts, nq)
    live = pairs[: counts[1]]
    host = torch.from_numpy(gr.group_pairs(live[:, 0], ids[live[:, 1]], nq))
    dense_t = torch.from_numpy(dense).to(torch.bfloat16)
    dev = gr.pair_tables(*(torch.from_numpy(a) for a in (ids, pairs, counts)), nq)
    np.testing.assert_array_equal(gr.accumulate_grouped(dense_t, host, nq).numpy(), want)
    np.testing.assert_array_equal(gr.accumulate_grouped_plain(dense_t, dev, nq).numpy(), want)


def test_accumulate_grouped_fp32_float_rows_within_ulps():
    """Float fp32 rows (the hybrid engine's float mode): each cell within
    4 x 2^-23 of its sum of |terms| of the exact (fp64) sum."""
    rng = np.random.default_rng(4)
    nq, t_heavy, n_pad = 9, 30, 640
    dense = (rng.random((t_heavy, n_pad)) * 3).astype(np.float32)
    dense[:, ::5] = 0
    pair_q = rng.integers(0, nq - 1, 40)  # the last query has no pair
    pair_rows = rng.integers(0, t_heavy, 40)
    table = torch.from_numpy(gr.group_pairs(pair_q, pair_rows, nq))
    got = gr.accumulate_grouped(torch.from_numpy(dense), table, nq).numpy()
    want = np.zeros((nq, n_pad))
    sum_abs = np.zeros((nq, n_pad))
    for q, r in zip(pair_q, pair_rows):
        want[q] += dense[r].astype(np.float64)
        sum_abs[q] += np.abs(dense[r]).astype(np.float64)
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= 4 * 2.0 ** -23 * sum_abs).all()
    assert not got[nq - 1].any()


def test_grouped_entries_skip_rows_and_slots_outside():
    """A hit row outside [0, t_heavy) and a slot outside [0, H) add
    nothing; a table too short for its queries raises."""
    dense = torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8)
    # hits [-1, 2, 9]; q0: slots 0, 1; q1: slots 1, 2, 5
    table = torch.tensor([3, 0, 2, 5, -1, 2, 9, 0, 1, 1, 2, 5], dtype=torch.int32)
    got = gr.accumulate_grouped(dense, table, 2)
    assert torch.equal(got, torch.stack([dense[2], dense[2]]))
    with pytest.raises(ValueError):
        gr.accumulate_grouped(dense, torch.zeros(3, dtype=torch.int32), 2)
