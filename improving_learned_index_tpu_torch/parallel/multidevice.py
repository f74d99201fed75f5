"""Multi-device dry run: train step, data-parallel encode, index, sharded search.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``
(``:88-374``), on a list of devices in one process: one ``Trainer`` step of
a tiny encoder (distillation loss, groups of 3), then ``DeepImpact``'s
data-parallel encode over ``devices`` and ``Indexer.build_inverted``, then
a ``ShardedSearchEngine`` over ``devices`` held to the host engine
(``search.engine.InvertedIndex``) and the single-device hybrid engine on
the dry run's tiny corpus, and on a sparse index of ``len(devices)`` x
524,288 + 777 docs whose shards are whole 65536-doc tiles.

``["cpu"] * n`` runs it on the CPU (the kernels' plain versions);
``["cuda:0"] * n`` on one card stands in for n cards.  The training step
runs on ``devices[0]``: the port's data-parallel training is one process
a card under ``torch.distributed`` (``parallel.distributed``), not a mesh.

Left out of the JAX dry run: the tensor-parallel FFN and embedding layout
(no JAX ``Trainer`` uses it), the partitioned tail (not ported, see
``search.sharded_engine``), the router's degraded mode (the port's serving
tests cover it) and the Llama leg (not ported yet).
"""

from __future__ import annotations

import tempfile
from typing import Sequence, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def sparse_tile_index(num_docs: int, seed: int = 5):
    """A sparse quantized index of ``num_docs`` docs: 4,000 seeded postings
    over 30 terms plus the tile-boundary docs (the JAX dry run's
    geometry)."""
    from ..index.inverted import InvertedIndexData

    rng = np.random.default_rng(seed)
    docs = np.concatenate([rng.integers(0, num_docs, 4000),
                           np.array([0, 65535, 65536, num_docs - 1])])
    per_doc = {}
    for t, d, v in zip(rng.integers(0, 30, len(docs)), docs, rng.integers(1, 256, len(docs))):
        per_doc.setdefault(int(d), {})[f"t{t}"] = int(v)
    return InvertedIndexData.build(sorted(per_doc.items()), num_docs=num_docs)


def _same_scores(got, want, what: str) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if [s for _, s in a] != [s for _, s in b] or dict(a) != dict(b):
            raise AssertionError(f"{what}: query {i} differs: {a[:5]} vs {b[:5]}")


def dryrun_multidevice(devices: Sequence[Device]) -> dict:
    """Run the dry run over ``devices``; raise ``AssertionError`` on any
    disagreement, return a summary."""
    from ..core.config import EncoderConfig, IndexConfig, TrainConfig
    from ..core.device import resolve_device
    from ..index.indexer import Indexer
    from ..models import DeepImpact
    from ..search.engine import InvertedIndex
    from ..search.hybrid_engine import HybridSearchEngine
    from ..search.sharded_engine import ShardedSearchEngine
    from ..text import ImpactTokenizer, WordPieceVocab
    from ..train.trainer import Trainer

    devices = [resolve_device(d) for d in devices]
    n = len(devices)
    geometry = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                    max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0)

    # 1. one training step: 2 query groups a device of 1 positive + 2 scored negatives
    group, seq = 3, 32
    groups = 2 * n
    rng = np.random.default_rng(0)
    batch = {
        "input_ids": rng.integers(1, 512, (groups * group, seq)).astype(np.int32),
        "attention_mask": np.ones((groups * group, seq), np.int32),
        "type_ids": np.zeros((groups * group, seq), np.int32),
        "masks": (rng.random((groups * group, seq)) < 0.2).astype(np.float32),
        "scores": rng.random((groups, group)).astype(np.float32),
    }
    model = DeepImpact(EncoderConfig(vocab_size=512, **geometry), None, seed=0, device=devices[0])
    train_config = TrainConfig(batch_size=groups, lr=1e-5, loss="distil_kl", group_size=group,
                               save_every=10**9, save_best=False)
    with tempfile.TemporaryDirectory() as ckpt:
        loss = Trainer(model, train_config, ckpt).train([batch], total_steps=1)
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    del model

    # 2. data-parallel encode -> quantized index (a softplus head: every term a posting)
    rng = np.random.default_rng(1)
    words = [f"word{i:03d}" for i in range(64)]
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    corpus = [" ".join(words[j] for j in rng.choice(len(words), size=12, p=p)) for _ in range(192)]
    vocab = WordPieceVocab.build(corpus, max_size=256)
    encoder = DeepImpact(EncoderConfig(vocab_size=len(vocab), impact_activation="softplus", **geometry),
                         ImpactTokenizer(vocab, max_length=32), seed=0, devices=devices)
    index, _ = Indexer(encoder, IndexConfig(max_length=32, max_terms=32, model_batch_size=32)
                       ).build_inverted(corpus)
    if index.num_postings == 0:
        raise AssertionError("the encode gave no postings")
    del encoder

    # 3. sharded search against the host engine and the single-device hybrid engine
    sharded = ShardedSearchEngine(index, devices, heavy_min=32)
    queries = [set(index.vocab[:3]), set(index.vocab[-2:]), {"nosuch"}]
    got = sharded.score_batch(queries, 10)
    _same_scores(got, InvertedIndex(index).score_batch(queries, 10), "sharded vs host")
    if got != HybridSearchEngine(index, heavy_min=32, device=devices[0]).score_batch(queries, 10):
        raise AssertionError("sharded vs hybrid: ranked lists differ")
    sharded.release()

    # 4. shards of whole 65536-doc tiles, all tail
    tile_docs = n * 524288 + 777
    tiles = sparse_tile_index(tile_docs)
    tiled = ShardedSearchEngine(tiles, devices, heavy_min=300)
    if tiled.shard_docs % 65536:
        raise AssertionError(f"shard_docs {tiled.shard_docs} is not tile-aligned")
    tq = [{f"t{i}" for i in range(8)}, {"t0"}, {"nosuch"}]
    _same_scores(tiled.score_batch(tq, 50), InvertedIndex(tiles).score_batch(tq, 50), "tile-aligned shards vs host")
    tiled.release()

    summary = {"devices": [str(d) for d in devices], "loss": float(loss),
               "postings": int(index.num_postings), "shard_docs": sharded.shard_docs,
               "tile_docs": tile_docs, "tile_shard_docs": tiled.shard_docs}
    print(f"dryrun_multidevice ok: {summary}", flush=True)
    return summary
