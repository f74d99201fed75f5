"""Hit-row gather-accumulate: the hybrid engine's heavy-term stage, reading
only the dense rows a query batch touches.

Counterpart of ``improving_learned_index_tpu/ops/gather_rows.py``.  Output
row q is the fp32 sum of the dense rows q's (query, row) pairs name;
duplicate pairs express repeated terms (reference semantics: summing whole
posting lists, src/deep_impact/inverted_index/inverted_index.py:55-62).

Two entries compute it:

- ``accumulate_grouped(dense, table, nq)``, which the engines call, takes
  the pairs as one int32 table, grouped by query on the host
  (``group_pairs``) and staged with one upload:

      [0]                     H, the number of hit rows
      [1, nq + 2)             qptr: query q's pairs are slots[qptr[q], qptr[q+1])
      [nq + 2, nq + 2 + H)    hits: the dense row of each slot
      [nq + 2 + H, len)       slots: each pair's slot in hits, grouped by
                              query, ascending within a query (entries past
                              qptr[nq] are ignored)

  The kernel stages each hit row once per doc tile and serves every query
  from shared memory (``csrc/gather_rows.cu``).
- ``accumulate_rows(dense, ids, pairs, counts, nq)`` keeps the JAX
  function's signature and semantics; on the card it builds the table with
  ``pair_tables`` (torch ops, no host sync) and calls the kernel.

A slot outside [0, H) and a row outside [0, t_heavy) are skipped.  Each
entry launches the hand-written kernel where ``_kernels.launches`` says so
(CUDA tensors) and runs its plain PyTorch version otherwise; there is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ._kernels import CudaKernel, launches, stream

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
KERNEL = CudaKernel("gather_rows", {"ili_gather_grouped_bf16": _ARGS, "ili_gather_grouped_f32": _ARGS})
_FN = {torch.bfloat16: "ili_gather_grouped_bf16", torch.float32: "ili_gather_grouped_f32"}
_MAX_TABLE = 2**31 - 1  # the kernel indexes the table with int32


def group_pairs(pair_q, pair_rows, nq: int) -> np.ndarray:
    """The kernel's table, on the host, from each pair's query and dense row
    (any order; pairs whose query is outside [0, nq) are dropped).  Hit rows
    ascend, and so do the slots within a query."""
    q = np.asarray(pair_q, dtype=np.int64).reshape(-1)
    rows = np.asarray(pair_rows, dtype=np.int64).reshape(-1)
    keep = (q >= 0) & (q < nq)
    q, rows = q[keep], rows[keep]
    hits, slot = np.unique(rows, return_inverse=True)
    slot = slot.reshape(-1)
    qptr = np.zeros(nq + 1, dtype=np.int64)
    np.cumsum(np.bincount(q, minlength=nq), out=qptr[1:])
    return np.concatenate(([len(hits)], qptr, hits, slot[np.lexsort((slot, q))])).astype(np.int32)


def pair_tables(ids, pairs, counts, nq: int) -> torch.Tensor:
    """The same table from the JAX layout, on the tensors' device with no
    host sync: hits are ``ids`` as given; live pairs (before counts[1], query
    in [0, nq), slot in [0, len(ids))) are sorted by (query, slot) and dead
    ones past every query."""
    dev = pairs.device
    h = ids.shape[0]
    q, s = pairs[:, 0].long(), pairs[:, 1].long()
    live = ((torch.arange(pairs.shape[0], device=dev) < counts[1])
            & (q >= 0) & (q < nq) & (s >= 0) & (s < h))
    key, order = torch.sort(torch.where(live, q * h + s, nq * h), stable=True)
    qptr = torch.searchsorted(key, torch.arange(nq + 1, device=dev) * h)
    return torch.cat([
        torch.full((1,), h, dtype=torch.int32, device=dev), qptr.int(), ids.int(),
        torch.where(live, s, 0)[order].int(),
    ])


def _check_dense(dense):
    if dense.dim() != 2 or dense.dtype not in _FN:
        raise ValueError(f"dense must be [t_heavy, n_pad] bf16 or fp32, got {tuple(dense.shape)} {dense.dtype}")


def _check(dense, ids, pairs, counts, nq):
    _check_dense(dense)
    if ids.dim() != 1 or pairs.dim() != 2 or pairs.shape[1] != 2 or counts.shape != (2,):
        raise ValueError("ids [H], pairs [P, 2] and counts [2] expected")
    for name, t in (("ids", ids), ("pairs", pairs), ("counts", counts)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
        if t.device != dense.device:
            raise ValueError(f"{name} on {t.device}, dense on {dense.device}")
    if nq < 0:
        raise ValueError("nq must be >= 0")


def _check_table(dense, table, nq):
    _check_dense(dense)
    if table.dim() != 1 or table.dtype != torch.int32 or table.device != dense.device:
        raise ValueError(f"table must be 1-D int32 on {dense.device}, got {table.dtype} on {table.device}")
    if nq < 0 or table.numel() < nq + 2:
        raise ValueError(f"a table for {nq} queries holds at least {nq + 2} entries, got {table.numel()}")
    if table.numel() > _MAX_TABLE:
        raise ValueError(f"table of {table.numel()} entries exceeds the kernel's {_MAX_TABLE}")


def _rows_product(dense, w, hit):
    """fp32 ``w @ dense[hit]`` with columns of rows outside the matrix
    zeroed; exact for integer cells while sums stay below 2^24.  On the card
    the product runs in full fp32: TF32 is switched off for matmuls here (it
    is off by default in PyTorch)."""
    t_heavy = dense.shape[0]
    if t_heavy == 0:
        return torch.zeros(w.shape[0], dense.shape[1], dtype=torch.float32, device=dense.device)
    inside = (hit >= 0) & (hit < t_heavy)
    if dense.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    return (w * inside) @ dense.index_select(0, hit.clamp(0, t_heavy - 1)).float()


def accumulate_rows_plain(dense, ids, pairs, counts, nq: int) -> torch.Tensor:
    """Plain PyTorch version of ``accumulate_rows``: the one-hot incidence
    product in fp32; ``w[q, slot]`` counts q's live pairs on ``slot``."""
    _check(dense, ids, pairs, counts, nq)
    dev = dense.device
    live = torch.arange(pairs.shape[0], device=dev) < counts[1]
    w = torch.zeros(nq, ids.shape[0], dtype=torch.float32, device=dev)
    # dead pairs (past counts[1]) add weight 0 at a valid cell: no host sync
    w.index_put_(
        (torch.where(live, pairs[:, 0], 0).long(), torch.where(live, pairs[:, 1], 0).long()),
        live.float(),
        accumulate=True,
    )
    return _rows_product(dense, w, ids.long())


def accumulate_grouped_plain(dense, table, nq: int) -> torch.Tensor:
    """Plain PyTorch version of ``accumulate_grouped``: the table's pairs as
    a one-hot incidence product in fp32 (reads H from the table: a host
    sync on the card)."""
    _check_table(dense, table, nq)
    dev = dense.device
    body = table.numel() - nq - 2
    h = min(max(int(table[0]), 0), body)
    qptr = table[1 : nq + 2].long().clamp(0, body - h)
    hits = table[nq + 2 : nq + 2 + h].long()
    slots = table[nq + 2 + h :].long()
    lens = (qptr[1:] - qptr[:-1]).clamp(min=0)
    q_of = torch.repeat_interleave(torch.arange(nq, device=dev), lens)
    first = torch.repeat_interleave(qptr[:-1] - (torch.cumsum(lens, 0) - lens), lens)
    slot = slots[first + torch.arange(q_of.numel(), device=dev)]
    ok = (slot >= 0) & (slot < h)
    q_of, slot = q_of[ok], slot[ok]
    w = torch.zeros(nq, h, dtype=torch.float32, device=dev)
    w.index_put_((q_of, slot), torch.ones_like(slot, dtype=torch.float32), accumulate=True)
    return _rows_product(dense, w, hits)


def accumulate_grouped(dense, table, nq: int) -> torch.Tensor:
    """Return [nq, n_pad] fp32 where row q = sum of the dense rows of q's
    pairs in ``table`` (the layout in the module docstring; ``group_pairs``
    builds it).  ``dense``: [t_heavy, n_pad] bf16 or fp32."""
    if not launches(dense):
        return accumulate_grouped_plain(dense, table, nq)
    _check_table(dense, table, nq)
    t_heavy, n_pad = dense.shape
    vec = 16 // dense.element_size()
    if not dense.is_contiguous() or n_pad % vec or dense.data_ptr() % 16:
        raise ValueError(f"dense must be contiguous, 16-byte aligned, n_pad % {vec} == 0")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    out = torch.empty(nq, n_pad, dtype=torch.float32, device=dense.device)
    if nq == 0 or n_pad == 0:
        return out
    KERNEL.call(
        _FN[dense.dtype],
        dense.data_ptr(), table.data_ptr(), table.numel(), out.data_ptr(),
        nq, t_heavy, n_pad, stream(dense), device=dense.device,
    )
    return out


def accumulate_rows(dense, ids, pairs, counts, nq: int) -> torch.Tensor:
    """Return [nq, n_pad] fp32 where row q = sum of dense rows whose
    (q, slot) incidence appears in ``pairs``.

    ``dense``: [t_heavy, n_pad] bf16 or fp32.  ``ids``: [H] int32 dense-row
    ids (entries past counts[0] ignored); ``pairs``: [P, 2] int32 (query
    row, ids slot) incidences in any order (entries past counts[1]
    ignored); ``counts``: [2] int32 (hit rows, pairs), on the same device.
    """
    if not launches(dense):
        return accumulate_rows_plain(dense, ids, pairs, counts, nq)
    _check(dense, ids, pairs, counts, nq)
    return accumulate_grouped(dense, pair_tables(ids, pairs, counts, nq), nq)
