"""Port's ``apply_tail_updates`` and ``apply_tail_chunks`` (tail stage)
against the JAX package's Pallas kernel, run through the Pallas interpreter
on the CPU, and the chunk entry against the JAX engines' own tail gathers.

Impacts are integers 1..255, so every comparison is exact.  The port
updates ``scores`` in place; the JAX function returns a new array.  The
CUDA kernel itself is held to the plain version on the card, in
test_torch_kernels_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from improving_learned_index_tpu.ops.pallas_scoring import BLK, QG, _hybrid_scores_topk
from improving_learned_index_tpu.ops.pallas_scoring import TAIL_CHUNK as BLOCKED_CHUNK
from improving_learned_index_tpu.ops.scatter_scores import PAGE, TILE
from improving_learned_index_tpu.ops.scatter_scores import (
    apply_tail_updates as jax_apply_tail_updates,
)
from improving_learned_index_tpu.search.hybrid_engine import _gather_tail as jax_gather_tail
from improving_learned_index_tpu_torch.ops import scatter_scores as ss
from improving_learned_index_tpu_torch.search.hybrid_engine import TAIL_CHUNK, expand_tail_chunks


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


def _postings(rng, lengths, n_docs):
    """Doc-ascending posting lists of the given lengths (impacts 1..255)
    concatenated, with their offsets."""
    docs = [np.sort(rng.choice(n_docs, n, replace=False)) for n in lengths]
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    vals = rng.integers(1, 256, int(offsets[-1]))
    return offsets, np.concatenate(docs).astype(np.int32), vals.astype(np.float32)


def _table(offsets, pairs, chunk):
    """The chunk table of (row, term) pairs, as the engines cut it."""
    rows, terms = (np.asarray(a, np.int64) for a in zip(*pairs))
    return expand_tail_chunks(offsets[terms], offsets[terms + 1], rows, chunk)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("slice_gather", [False, True])
def test_apply_tail_chunks_matches_jax_gather_tail(slice_gather):
    """The hybrid engine's tail: 512-slot chunks (an even number of them, as
    the Pallas kernel's 1024-update pages need), partial last chunks, one
    term twice in a row and two terms sharing docs (duplicate (row, doc)
    pairs), n_pad a multiple of 65536; the JAX side is its engine's
    ``_gather_tail`` and the Pallas tail kernel in interpret mode."""
    assert TAIL_CHUNK == 512
    rng = np.random.default_rng(6)
    nq, n_pad = 8, 2 * TILE
    offsets, docs, vals = _postings(rng, [700, 512, 90, 1300, 5, 260, 33], n_pad)
    docs[offsets[6]:offsets[7]] = docs[offsets[1]:offsets[1] + 33]  # shared docs
    pairs = [(0, 0), (0, 0), (1, 1), (1, 6), (2, 2), (3, 3), (5, 4), (7, 5), (6, 3), (4, 2)]
    starts, lengths, rows = _table(offsets, pairs, TAIL_CHUNK)
    assert len(starts) % 2 == 0 and (lengths < TAIL_CHUNK).any()
    # the engines pad the posting arrays with a chunk of zeros (slice_gather's
    # whole-chunk reads stay in bounds)
    docs = np.concatenate([docs, np.zeros(TAIL_CHUNK, np.int32)])
    vals = np.concatenate([vals, np.zeros(TAIL_CHUNK, np.float32)])
    scores = rng.integers(0, 300, (nq, n_pad)).astype(np.float32)
    d, v, r, _ = jax_gather_tail(jnp.asarray(docs), jnp.asarray(vals), jnp.asarray(starts),
                                 jnp.asarray(lengths), jnp.asarray(rows), slice_gather=slice_gather)
    want = np.asarray(jax_apply_tail_updates(jnp.asarray(scores), d, v, r, interpret=True))
    s = torch.from_numpy(scores.copy())
    got = ss.apply_tail_chunks(s, *_torch(docs, vals, starts, lengths, rows), TAIL_CHUNK)
    assert got is s  # in place
    np.testing.assert_array_equal(got.numpy(), want)


def test_apply_tail_chunks_matches_jax_blocked_tail():
    """The blocked engine's tail: 1024-slot chunks over postings with
    docs == -1 padding (inside windows and at the array end); the JAX side is
    its engine's jitted tail gather + XLA scatter (``_hybrid_scores_topk``
    without the kernel), read back from a top-k over every doc."""
    rng = np.random.default_rng(7)
    nq, num_blocks = QG, 3
    num_docs = num_blocks * BLK - 100
    offsets, docs, vals = _postings(rng, [2500, 1024, 17, 900], num_docs)
    docs[rng.choice(len(docs), 40, replace=False)] = -1
    docs = np.concatenate([docs, np.full(BLOCKED_CHUNK, -1, np.int32)])
    vals = np.concatenate([vals, np.zeros(BLOCKED_CHUNK, np.float32)])
    starts, lengths, rows = _table(offsets, [(0, 0), (1, 1), (1, 0), (4, 2), (7, 3), (7, 3)],
                                   BLOCKED_CHUNK)
    z = jnp.zeros(1, jnp.int32)
    top, idx = _hybrid_scores_topk(
        jnp.zeros(nq // QG * num_blocks + 1, jnp.int32), z, z, jnp.asarray(np.stack([starts, lengths, rows])),
        jnp.asarray(docs[None]), jnp.asarray(vals[None]), nq, num_blocks, num_docs, num_docs,
        False, False,
    )
    want = np.zeros((nq, num_docs), np.float32)
    np.put_along_axis(want, np.asarray(idx), np.asarray(top), axis=1)
    got = ss.apply_tail_chunks(torch.zeros(nq, num_blocks * BLK), *_torch(docs, vals, starts, lengths, rows),
                               BLOCKED_CHUNK)
    assert (got[:, num_docs:] == 0).all()
    np.testing.assert_array_equal(got[:, :num_docs].numpy(), want)


@pytest.mark.parametrize("chunk", [1, 7, 512])
def test_apply_tail_chunks_equals_gathered_updates(chunk):
    """Random tables (lengths past the chunk, empty chunks, -1 docs): the
    chunk entry equals ``apply_tail_updates(*gather_updates(...))`` and an
    ``np.add.at`` of the same windows."""
    rng = np.random.default_rng(chunk)
    nq, n_pad, n_post, n_chunks = 5, 3000, 4000, 40
    docs = rng.integers(-1, n_pad, n_post).astype(np.int32)
    vals = rng.integers(1, 256, n_post).astype(np.float32)
    lengths = rng.integers(0, chunk + 3, n_chunks).astype(np.int32)
    starts = rng.integers(0, n_post - chunk - 3, n_chunks).astype(np.int32)
    rows = rng.integers(0, nq, n_chunks).astype(np.int32)
    scores = rng.integers(0, 50, (nq, n_pad)).astype(np.float32)
    want = scores.copy()
    for s0, ln, r in zip(starts, np.minimum(lengths, chunk), rows):
        d = docs[s0:s0 + ln]
        np.add.at(want[r], d[d >= 0], vals[s0:s0 + ln][d >= 0])
    table = _torch(docs, vals, starts, lengths, rows)
    got = ss.apply_tail_chunks(torch.from_numpy(scores.copy()), *table, chunk)
    flat = ss.apply_tail_updates(torch.from_numpy(scores.copy()), *ss.gather_updates(*table, chunk))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, flat)


def test_apply_tail_chunks_checks_arguments():
    """The chunk entry refuses malformed tables before any launch, and a
    device with neither a kernel nor a plain route raises instead of falling
    back."""
    docs, starts = torch.zeros(10, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    vals, scores = torch.ones(10), torch.zeros(2, 16)
    ok = (docs, vals, starts, starts, starts)
    ss.apply_tail_chunks(scores, *ok, 4)
    bad = [
        ((torch.zeros(2, 16, dtype=torch.float64), *ok, 4), "fp32"),
        ((scores, docs.float(), vals, starts, starts, starts, 4), "int32"),
        ((scores, docs, vals[:5], starts, starts, starts, 4), "one length"),
        ((scores, docs, vals, starts, starts[:1], starts, 4), "one length"),
        ((scores, docs, vals, starts, starts.long(), starts, 4), "int32"),
        ((scores, *ok, 0), "positive"),
    ]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            ss.apply_tail_chunks(*args)
    with pytest.raises(ValueError, match="no kernel and no plain version for device meta"):
        ss.apply_tail_chunks(scores.to("meta"), *(t.to("meta") for t in ok), 4)
