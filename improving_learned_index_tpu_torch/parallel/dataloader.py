"""Host-side batch iterator (the port's copy of
``improving_learned_index_tpu/parallel/dataloader.py``: the same seeded
shuffle, so the same batch order).

Replaces torch DataLoader + DistributedSampler (reference train.py:175-184):
one *global* batch per step, the same on every rank; each data-parallel
rank takes its own query groups of it (``parallel.distributed``).
Deterministic epoch shuffling by seed, drop_last
semantics, and a ``skip`` offset for resume parity.  A small background
thread prefetches ``PREFETCH`` collated batches so host tokenization
overlaps device steps (the reference used num_workers=0); it stops when the
consumer closes the epoch's generator (a run that ends at ``total_steps``).
"""

from __future__ import annotations

import threading
from queue import Full, Queue
from typing import Any, Callable, Dict, Iterator, Optional, Sequence

import numpy as np

PREFETCH = 2  # collated batches the producer thread runs ahead


class BatchLoader:
    def __init__(
        self,
        dataset,  # indexable + len()
        batch_size: int,
        collate_fn: Callable[[Sequence[Any]], Dict[str, np.ndarray]],
        shuffle: bool = True,
        seed: int = 42,
        drop_last: bool = True,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _indices(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        return idx

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices(epoch)
        queue: Queue = Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    queue.put(item, timeout=0.1)
                    return True
                except Full:
                    pass
            return False

        def produce():
            try:
                batch = []
                for i in idx:
                    batch.append(self.dataset[int(i)])
                    if len(batch) == self.batch_size:
                        if not put(self.collate_fn(batch)):
                            return
                        batch = []
                if batch and not self.drop_last and not put(self.collate_fn(batch)):
                    return
                put(None)
            except Exception as e:  # raised in the consumer, not lost with the thread
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = queue.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()

    def __iter__(self):
        return self.epoch(0)
