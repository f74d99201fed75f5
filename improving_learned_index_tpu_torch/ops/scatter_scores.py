"""Tail scatter: apply sparse (query, doc, impact) updates to a dense score
matrix.

Counterpart of ``improving_learned_index_tpu/ops/scatter_scores.py``
(reference semantics: the per-posting ``scores[doc] += impact`` loop in
src/deep_impact/inverted_index/inverted_index.py:55-62).

Two entries, one kernel library (``csrc/scatter_scores.cu``):

- ``apply_tail_updates(scores, d, v, r)`` takes flat update arrays, as the
  JAX function does;
- ``apply_tail_chunks(scores, docs, vals, starts, lengths, rows, chunk)``
  takes the engines' chunk table and reads the posting arrays in place: it
  computes ``apply_tail_updates(scores, *gather_updates(...))`` without
  materializing the flat arrays.

Each launches the hand-written kernel where ``_kernels.launches`` says so
(CUDA tensors) and runs the plain PyTorch version otherwise; there is no
fallback from one to the other.

Unlike the JAX function, which returns a new array, both versions update
``scores`` in place and return it: at corpus scale the score matrix is
[64, 8.85M] fp32 (2.3 GB), and a copy per batch would double its traffic.
"""

from __future__ import annotations

import ctypes

import torch

from ._kernels import CudaKernel, launches, stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel(
    "scatter_scores",
    {
        "ili_scatter_scores": [_P] * 4 + [_L, _I, _L, _P],
        "ili_scatter_chunks": [_P] * 6 + [_L, _I, _I, _L, _P],
    },
)


def _check(scores, d, v, r):
    if scores.dim() != 2 or scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous [nq, n_pad] fp32 tensor")
    if not (d.shape == v.shape == r.shape) or d.dim() != 1:
        raise ValueError("d, v and r must be flat arrays of one length")
    if d.dtype != torch.int32 or r.dtype != torch.int32 or v.dtype != torch.float32:
        raise ValueError("d and r must be int32 and v fp32")
    for name, t in (("d", d), ("v", v), ("r", r)):
        if t.device != scores.device:
            raise ValueError(f"{name} on {t.device}, scores on {scores.device}")


def _check_chunks(scores, docs, vals, starts, lengths, rows, chunk):
    if scores.dim() != 2 or scores.dtype != torch.float32 or not scores.is_contiguous():
        raise ValueError("scores must be a contiguous [nq, n_pad] fp32 tensor")
    if docs.dim() != 1 or docs.shape != vals.shape:
        raise ValueError("docs and vals must be flat arrays of one length")
    if docs.dtype != torch.int32 or vals.dtype != torch.float32:
        raise ValueError("docs must be int32 and vals fp32")
    if not (starts.shape == lengths.shape == rows.shape) or starts.dim() != 1:
        raise ValueError("starts, lengths and rows must be flat arrays of one length")
    for name, t in (("starts", starts), ("lengths", lengths), ("rows", rows)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if chunk < 1:
        raise ValueError(f"chunk must be positive, got {chunk}")
    for name, t in (("docs", docs), ("vals", vals), ("starts", starts),
                    ("lengths", lengths), ("rows", rows)):
        if t.device != scores.device:
            raise ValueError(f"{name} on {t.device}, scores on {scores.device}")


def _launch(fn, scores, *args):
    """Launch ``fn`` on ``scores`` and the current stream."""
    nq, n_pad = scores.shape
    KERNEL.call(fn, scores.data_ptr(), *args, nq, n_pad, stream(scores), device=scores.device)
    return scores


def _require_contiguous(**tensors):
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def apply_tail_updates_plain(scores, d, v, r) -> torch.Tensor:
    """Plain PyTorch version: accumulate ``index_put_`` in place.  Padding
    (v == 0) is redirected to cell [0, 0], where it adds an exact zero, so
    no host sync is needed to drop it."""
    _check(scores, d, v, r)
    pad = v == 0
    idx = (torch.where(pad, 0, r).long(), torch.where(pad, 0, d).long())
    return scores.index_put_(idx, v, accumulate=True)


def apply_tail_updates(scores, d, v, r) -> torch.Tensor:
    """``scores[r[i], d[i]] += v[i]`` for every i, exactly, in place.

    ``scores``: [nq, n_pad] fp32; ``d``/``r`` int32 and ``v`` fp32 flat
    update arrays of any length.  Updates with v == 0 are padding and
    ignored.  Impacts are integers (quantized lattice), so fp32 sums are
    exact in any order below 2^24.
    """
    if not launches(scores):
        return apply_tail_updates_plain(scores, d, v, r)
    _check(scores, d, v, r)
    _require_contiguous(d=d, v=v, r=r)
    if d.numel() == 0 or scores.numel() == 0:
        return scores
    return _launch("ili_scatter_scores", scores, d.data_ptr(), v.data_ptr(), r.data_ptr(), d.numel())


def gather_updates(docs, vals, starts, lengths, rows, chunk: int):
    """Flat (doc, value, row) updates of a chunk table, as
    ``apply_tail_updates`` takes them: chunk i reads ``chunk`` positions
    from ``starts[i]`` of ``docs`` (int32, -1 = padding) and ``vals``
    (fp32); lanes past ``lengths[i]`` or on padding get value 0 (and doc
    0).  ``starts``/``lengths``/``rows``: int32 on the device of ``docs``."""
    offs = torch.arange(chunk, dtype=torch.int32, device=docs.device)[None, :]
    valid = offs < lengths[:, None]
    pos = torch.where(valid, starts[:, None] + offs, 0).reshape(-1)
    d = docs.index_select(0, pos)
    v = torch.where(valid.reshape(-1) & (d >= 0), vals.index_select(0, pos), 0.0)
    return torch.where(d >= 0, d, 0), v, rows[:, None].expand(-1, chunk).reshape(-1)


def apply_tail_chunks_plain(scores, docs, vals, starts, lengths, rows, chunk: int) -> torch.Tensor:
    """Plain PyTorch version of ``apply_tail_chunks``: the flat updates
    materialized by ``gather_updates``, then ``apply_tail_updates_plain``."""
    _check_chunks(scores, docs, vals, starts, lengths, rows, chunk)
    return apply_tail_updates_plain(scores, *gather_updates(docs, vals, starts, lengths, rows, chunk))


def apply_tail_chunks(scores, docs, vals, starts, lengths, rows, chunk: int) -> torch.Tensor:
    """``apply_tail_updates(scores, *gather_updates(docs, vals, starts,
    lengths, rows, chunk))``, in place, with the chunk table read where it
    lies: no flat update array is materialized.

    Every window ``starts[i] .. starts[i] + min(lengths[i], chunk)`` must
    lie inside ``docs``/``vals``; lanes past it are never read.
    """
    if not launches(scores):
        return apply_tail_chunks_plain(scores, docs, vals, starts, lengths, rows, chunk)
    _check_chunks(scores, docs, vals, starts, lengths, rows, chunk)
    _require_contiguous(docs=docs, vals=vals, starts=starts, lengths=lengths, rows=rows)
    if starts.numel() == 0 or scores.numel() == 0:
        return scores
    return _launch("ili_scatter_chunks", scores, docs.data_ptr(), vals.data_ptr(),
                   starts.data_ptr(), lengths.data_ptr(), rows.data_ptr(), starts.numel(), chunk)
