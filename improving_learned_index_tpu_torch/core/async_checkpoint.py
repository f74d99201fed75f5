"""Asynchronous checkpointing: the snapshot is written while training goes on.

Counterpart of ``improving_learned_index_tpu/core/orbax_checkpoint.py``
(``OrbaxCheckpointManager``): the same latest/step/best/final snapshots
``<name>_<suffix>``, each beside a ``.meta.json`` with ``step``,
``batch_size``, ``has_opt_state`` and ``metric``; ``on_step``, ``save``,
``load``, ``wait``, ``exists`` and ``rescale_step_for_batch``.  It has the
interface of ``core.checkpoint.CheckpointManager`` and can stand in for a
``Trainer``'s ``manager``.

- The state is copied to the host before ``on_step`` (or ``save``) returns:
  a training step updates the module's and the optimizer's tensors in
  place.  Card tensors go to pinned buffers with non-blocking copies on the
  current stream, so the next optimizer step, queued behind them, cannot
  change what they read; the writer waits for the copies' event.  The
  buffers are reused from one snapshot to the next.
- One host copy per call, written under every suffix that call saves (the
  step's and latest, and best); one writer thread, at most one snapshot in
  flight: the next save joins the one before (orbax semantics).
- An error on the writer thread is raised again at ``wait()`` or at the
  next save.

Deviations from the JAX manager: the payload is one ``torch.save`` file
(``.pt``, as ``core.checkpoint`` writes) in place of an orbax directory; each
file is written to a temporary name and renamed into place, and a
snapshot's ``.meta.json`` is written after its payload has landed (orbax's
meta is written when the save starts), so a resume never reads a step whose
weights never landed.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from .checkpoint import LATEST_SNAPSHOT_SUFFIX, CheckpointManager, _write, _write_meta
from .logging import get_logger

logger = get_logger("async_checkpoint", stream=False)


class AsyncCheckpointManager(CheckpointManager):
    """Snapshots written on a writer thread from a host copy of the state."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._buffers: Dict[Tuple, torch.Tensor] = {}
        self._from_card = False

    # -- the writer ------------------------------------------------------------
    def wait(self) -> None:
        """Join the snapshot in flight; raise its writer's error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _to_host(self, x: Any, key: Tuple) -> Any:
        if isinstance(x, torch.Tensor):
            buf = self._buffers.get(key)
            if buf is None or buf.shape != x.shape or buf.dtype != x.dtype:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
                self._buffers[key] = buf
            buf.copy_(x.detach(), non_blocking=x.is_cuda)
            self._from_card |= x.is_cuda
            return buf
        if isinstance(x, dict):
            out = type(x)((k, self._to_host(v, key + (k,))) for k, v in x.items())
            if hasattr(x, "_metadata"):  # a state_dict's module versions
                out._metadata = dict(x._metadata)
            return out
        if isinstance(x, (list, tuple)):
            return type(x)(self._to_host(v, key + (i,)) for i, v in enumerate(x))
        return x

    def _submit(self, entries: List[Tuple[str, Dict]], params, opt_state) -> None:
        """Copy the state to the host and start writing it under each
        (suffix, meta) of ``entries``."""
        self.wait()
        self._from_card = False
        payload = {"params": self._to_host(params, ("params",))}
        if opt_state is not None:
            payload["opt_state"] = self._to_host(opt_state, ("opt_state",))
        event = None
        if self._from_card:  # the copies are queued on the current stream
            event = torch.cuda.Event()
            event.record()
        self._thread = threading.Thread(target=self._write_all, args=(entries, payload, event),
                                        name="async-checkpoint")
        self._thread.start()

    def _write_all(self, entries, payload, event) -> None:
        try:
            if event is not None:
                event.synchronize()
            first = None
            for suffix, meta in entries:
                path = self._path(suffix)
                if first is None:
                    _write(path, payload)
                    first = path
                else:
                    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                    shutil.copyfile(first, tmp)
                    os.replace(tmp, path)
                _write_meta(self._meta_path(suffix), meta)
                logger.info(f"saved checkpoint {path.name}")
        except Exception as e:  # the writer thread's boundary: raised again by wait()
            self._error = e

    # -- save --------------------------------------------------------------------
    def save(
        self,
        suffix: str,
        params: Dict[str, torch.Tensor],
        opt_state: Optional[Dict[str, Any]] = None,
        metric: Optional[float] = None,
    ) -> None:
        if not self.writer:
            return
        self._submit([(suffix, self._meta(opt_state is not None, metric))], params, opt_state)

    def on_step(
        self,
        params: Dict[str, torch.Tensor],
        opt_state: Optional[Dict[str, Any]] = None,
        metric: Optional[float] = None,
    ) -> None:
        self.step += 1
        suffixes = []
        if self.step % self.save_every == 0:
            suffixes += [str(self.step), LATEST_SNAPSHOT_SUFFIX]
        if self.save_best and metric is not None and metric < self.best_metric:
            self.best_metric = metric
            suffixes.append("best")
        if suffixes and self.writer:
            meta = self._meta(opt_state is not None, metric)
            self._submit([(s, meta) for s in suffixes], params, opt_state)

    # -- load ----------------------------------------------------------------------
    def load(self, suffix: str = LATEST_SNAPSHOT_SUFFIX) -> Dict[str, Any]:
        self.wait()
        return super().load(suffix)
