"""Port's ``exact_topk_integer`` against the JAX package's: values AND doc
ids, rank by rank (boundary ties in doc-id order), exactly, on both of its
routes (the n-ary search, and the value histogram taken when the caller
bounds the scores below ``topk_select.BINS``)."""

from collections import Counter

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from improving_learned_index_tpu.ops.exact_topk import exact_topk_integer as jax_topk
from improving_learned_index_tpu_torch.ops import exact_topk, topk_select
from improving_learned_index_tpu_torch.ops.exact_topk import exact_topk_integer
from improving_learned_index_tpu_torch.ops.topk_select import BINS


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
    if case == "bound_is_bins_minus_1":  # the histogram's top bin in use
        s = rng.integers(0, BINS, (4, 5000))
        s[:, 17] = BINS - 1
        s[2, 4000] = BINS - 1  # a tie at the top
        return s, 300
    if case == "ties_over_many_blocks":  # s_k = 1, its run over every 256-doc block
        s = (rng.random((3, 20000)) < 0.5).astype(np.int64)
        s[rng.random((3, 20000)) < 0.05] = 2
        return s, 3000
    if case == "one_row":
        return rng.integers(0, 100, (1, 4000)), 500
    if case == "exactly_k_positives":
        s = np.zeros((3, 2000))
        for row in s:
            row[rng.choice(2000, 100, replace=False)] = rng.integers(1, 60, 100)
        return s, 100
    if case == "strided_view":  # a sliced [:, :3001] view of a wider matrix
        return rng.integers(0, 40, (6, 3001)), 250
    return rng.integers(0, 4000, (8, 65536)), 1000  # wide


CASES = ["boundary_ties", "k_ge_n", "all_zero_rows", "width_not_multiple_of_256", "k_is_1",
         "sparse_rows", "wide", "bound_is_bins_minus_1", "ties_over_many_blocks", "one_row",
         "exactly_k_positives", "strided_view"]


@pytest.mark.parametrize("route", ["nary", "histogram"])
@pytest.mark.parametrize("case", CASES)
def test_exact_topk_matches_jax(case, route):
    """``histogram``: ``max_score`` the case's true bound (its largest
    score); ``nary``: no bound."""
    scores, k = _scores(case, np.random.default_rng(3))
    scores = scores.astype(np.float32)
    v_j, i_j = (np.asarray(a) for a in jax_topk(jnp.asarray(scores), k))
    x = torch.from_numpy(scores)
    if case == "strided_view":
        x = torch.zeros(scores.shape[0], 3200)
        x[:, :3001] = torch.from_numpy(scores)
        x = x[:, :3001]
        assert not x.is_contiguous()
    bound = float(scores.max()) if route == "histogram" else None
    assert bound is None or bound < BINS
    v_t, i_t = exact_topk_integer(x, k, max_score=bound)
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


@pytest.mark.parametrize("bound, route", [
    (None, "nary"), (BINS, "nary"), (2.0 * BINS, "nary"), (BINS - 1, "histogram"), (2999.0, "histogram"),
])
def test_route_follows_the_bound(monkeypatch, bound, route):
    """A bound below BINS takes the histogram route: no search test and no
    count; none, or one at or past BINS, the n-ary route.  Both give the
    same answer."""
    calls = Counter()
    for name in ("_searching", "count_ge", "value_histogram_plain"):
        holder = topk_select if name == "value_histogram_plain" else exact_topk
        inner = getattr(holder, name)

        def counted(*args, _inner=inner, _name=name, **kwargs):
            calls[_name] += 1
            return _inner(*args, **kwargs)

        monkeypatch.setattr(holder, name, counted)
    scores = torch.from_numpy(np.random.default_rng(9).integers(0, 3000, (4, 5000)).astype(np.float32))
    got = exact_topk_integer(scores, 100, max_score=bound)
    if route == "histogram":
        assert calls == Counter(value_histogram_plain=1)
    else:
        assert calls["_searching"] >= 2 and calls["count_ge"] >= 1
        assert calls["value_histogram_plain"] == 0
    want = exact_topk_integer(scores, 100, max_score=None if route == "histogram" else BINS - 1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_selection_pieces():
    """The plain histogram, k-th scores and block counts on a hand-made row:
    values 0-3 in the first 256-doc block, a 5 in the ragged second."""
    scores = torch.zeros(1, 300)
    scores[0, :4] = torch.tensor([1.0, 2.0, 2.0, 3.0])
    scores[0, 299] = 5.0
    hist, block_max = topk_select.value_histogram(scores)
    assert hist[0, :6].tolist() == [0, 1, 2, 1, 0, 1] and int(hist.sum()) == 5
    assert block_max.tolist() == [[3, 5]]
    assert topk_select.kth_scores(hist, 3).tolist() == [[2.0]]  # |{v >= 2}| = 4, |{v >= 3}| = 2
    assert topk_select.kth_scores(hist, 9).tolist() == [[1.0]]  # fewer than 9 positives
    gt, eq = topk_select.block_counts(scores, torch.tensor([[2.0]]))
    assert gt.tolist() == [[1, 1]] and eq.tolist() == [[2, 0]]
    assert gt.dtype == eq.dtype == hist.dtype == block_max.dtype == torch.int32


def test_bins_match_the_kernel_source():
    """The wrapper's BINS is the CUDA source's kBins."""
    assert f"constexpr int kBins = {BINS};" in topk_select.KERNEL.source.read_text()
