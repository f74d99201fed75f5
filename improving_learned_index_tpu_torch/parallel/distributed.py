"""Data parallelism with ``torch.distributed``: the counterpart of
``improving_learned_index_tpu/parallel/mesh.py``.

The JAX step takes one global batch, shards it over the mesh's ``data``
axis and lets XLA psum the gradients.  Here every rank is a process with its
own replica (``DistributedDataParallel`` averages the gradients): each rank
takes its contiguous slice of the global batch's query groups and computes
the mean loss over them.  The mean of equal per-rank means is the global
mean, so a batch whose groups divide the world size gives the JAX step's
gradients; one that does not, or whose loss couples every group
(``in_batch_negatives`` scores each query against all negatives), is
replicated: every rank computes the whole batch, as the JAX trainer
replicates an indivisible batch (trainer.py:223-236).

Packed batches are split before packing (``rank_collate`` under
``train.packed.packing_collate``): a pairwise or distillation loss needs all
of a group's documents on one rank, and a packed row may hold documents of
several groups.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.logging import get_logger

logger = get_logger("distributed", stream=False)


def initialize_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    Arguments left out come from the environment a launcher such as
    ``torchrun`` sets (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); a world of one process starts no group.  ``backend``:
    NCCL where CUDA is available, else gloo.  With NCCL each process takes
    the card ``LOCAL_RANK`` (default: its rank)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    if world_size <= 1:
        return 0, 1
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank)
    return rank, world_size


def rank_and_world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_groups(arrays: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    """This rank's contiguous slice of a collated (unpacked) batch's query
    groups: document rows [N, ...] by ``group_size`` rows a group, per-group
    arrays ([G, ...], the teacher scores) by group.  Returns ``arrays``
    itself (replicated) when the groups do not divide the world size or an
    array is neither per document nor per group."""
    if world == 1:
        return arrays
    n = np.shape(arrays["input_ids"])[0]
    gs = int(arrays["group_size"])
    groups = n // gs
    shapes = [np.shape(v) for k, v in arrays.items() if k != "group_size"]
    if groups % world or any(s[0] not in (n, groups) for s in shapes):
        return arrays
    per = groups // world
    out = {}
    for k, v in arrays.items():
        if k == "group_size":
            out[k] = v
            continue
        unit = gs if np.shape(v)[0] == n else 1
        out[k] = v[rank * per * unit : (rank + 1) * per * unit]
    return out


def rank_collate(collate: Callable, rank: int, world: int) -> Callable:
    """Wrap a collate so it returns this rank's query groups of each global
    batch (``shard_groups``)."""
    if world == 1:
        return collate
    warned = []

    def sharded(batch, *args, **kwargs):
        arrays = collate(batch, *args, **kwargs)
        out = shard_groups(arrays, rank, world)
        if out is arrays and not warned:
            warned.append(True)
            logger.warning(
                f"a batch of {np.shape(arrays['input_ids'])[0]} rows is replicated on all "
                f"{world} ranks, not split: its query groups do not divide the world size "
                "or its loss couples every group"
            )
        return out

    return sharded
