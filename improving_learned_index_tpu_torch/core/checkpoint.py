"""Checkpointing with latest/step/best/final semantics + training resume.

Counterpart of ``improving_learned_index_tpu/core/checkpoint.py`` with the
same names and metadata: snapshots ``<name>_latest``, ``<name>_<step>``,
``<name>_best`` (lowest metric) and ``<name>_final``, each beside a
``.meta.json`` sidecar (``step``, ``batch_size``, ``has_opt_state``,
``metric``), so resume can rescale the step when the global batch changes
(reference training/trainer.py:63-66).

The payload is one ``torch.save`` file (``.pt``): ``{"params": the
module's state_dict, "opt_state": the optimizer's state_dict}``, written to
a temporary name and renamed into place, and read back with
``weights_only=True``.

``load_params`` also reads the JAX package's flax msgpack files (its
``save_params`` and ``CheckpointManager`` snapshots, ``.msgpack``) through
``core.flax_msgpack``, and maps their parameter tree onto the port's state
dict with ``models.hf_import.flax_params_to_port`` (which needs the model's
``EncoderConfig``).  A training resume from such a snapshot raises: optax's
AdamW state does not map onto ``torch.optim.AdamW``'s.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from .logging import get_logger

logger = get_logger("checkpoint", stream=False)

EXTENSION = "pt"
JAX_EXTENSION = "msgpack"
LATEST_SNAPSHOT_SUFFIX = "latest"


def _write(path: Path, payload: Any) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _write_meta(path: Path, meta: Dict[str, Any]) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path)


def _read(path: Union[str, Path]) -> Any:
    path = Path(path)
    if path.suffix == f".{JAX_EXTENSION}":
        from .flax_msgpack import read

        return read(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def save_params(path: Union[str, Path], params: Dict[str, torch.Tensor]) -> None:
    """A bare state dict as one ``.pt`` file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    _write(path, dict(params))


def _unwrap_payload(restored: Any) -> Any:
    """Unwrap a CheckpointManager payload ({'params', 'opt_state'?}) to bare
    params, so trainer-produced checkpoints feed the index and rank CLIs the
    way the reference's ModelCheckpoint.load unwraps model_state_dict
    (src/utils/checkpoint.py:86-139)."""
    if (
        isinstance(restored, dict)
        and "params" in restored
        and set(restored) <= {"params", "opt_state"}
    ):
        return restored["params"]
    return restored


def load_params(path: Union[str, Path], config=None) -> Dict[str, torch.Tensor]:
    """The state dict of a ``save_params`` file or a manager snapshot (CPU
    tensors).  A JAX ``.msgpack`` file's flax parameter tree is mapped onto
    the port's state dict for ``config`` (the model's ``EncoderConfig``)."""
    params = _unwrap_payload(_read(path))
    if Path(path).suffix != f".{JAX_EXTENSION}":
        return params
    if config is None:
        raise ValueError(f"{path}: a flax parameter tree needs the model's EncoderConfig to map it")
    from ..models.hf_import import flax_params_to_port

    return flax_params_to_port(params, config)


class CheckpointManager:
    """Save/restore (params, opt_state, step, batch_size) snapshots.

    ``writer=False`` (every data-parallel rank but 0) keeps the step count
    and writes nothing."""

    def __init__(
        self,
        checkpoint_dir: Union[str, Path],
        name: str = "DeepImpact",
        save_every: int = 1,
        save_best: bool = False,
        batch_size: int = 0,
        writer: bool = True,
    ):
        self.checkpoint_dir = Path(checkpoint_dir)
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        self.name = name
        self.save_every = save_every
        self.save_best = save_best
        self.batch_size = batch_size
        self.writer = writer
        self.step = 0
        self.best_metric = float("inf")

    # -- paths ---------------------------------------------------------------
    def _path(self, suffix: str) -> Path:
        return self.checkpoint_dir / f"{self.name}_{suffix}.{EXTENSION}"

    def _meta_path(self, suffix: str) -> Path:
        return self.checkpoint_dir / f"{self.name}_{suffix}.meta.json"

    def _jax_path(self, suffix: str) -> Path:
        """The JAX package's snapshot of the same name (resume refuses it)."""
        return self.checkpoint_dir / f"{self.name}_{suffix}.{JAX_EXTENSION}"

    @property
    def latest_path(self) -> Path:
        return self._path(LATEST_SNAPSHOT_SUFFIX)

    def exists(self) -> bool:
        return self.latest_path.exists() or self._jax_path(LATEST_SNAPSHOT_SUFFIX).exists()

    # -- save ------------------------------------------------------------------
    def save(
        self,
        suffix: str,
        params: Dict[str, torch.Tensor],
        opt_state: Optional[Dict[str, Any]] = None,
        metric: Optional[float] = None,
    ) -> None:
        if not self.writer:
            return
        payload = {"params": params}
        if opt_state is not None:
            payload["opt_state"] = opt_state
        _write(self._path(suffix), payload)
        _write_meta(self._meta_path(suffix), self._meta(opt_state is not None, metric))
        logger.info(f"saved checkpoint {self._path(suffix).name}")

    def _meta(self, has_opt_state: bool, metric: Optional[float]) -> Dict[str, Any]:
        """The ``.meta.json`` of a snapshot taken now."""
        meta = {"step": self.step, "batch_size": self.batch_size, "has_opt_state": has_opt_state}
        if metric is not None:
            meta["metric"] = metric
        return meta

    def on_step(
        self,
        params: Dict[str, torch.Tensor],
        opt_state: Optional[Dict[str, Any]] = None,
        metric: Optional[float] = None,
    ) -> None:
        """Per-step callback (reference checkpoint.py:55-66)."""
        self.step += 1
        if self.step % self.save_every == 0:
            self.save(str(self.step), params, opt_state, metric)
            self.save(LATEST_SNAPSHOT_SUFFIX, params, opt_state, metric)
        if self.save_best and metric is not None and metric < self.best_metric:
            self.best_metric = metric
            self.save("best", params, opt_state, metric)

    # -- load ------------------------------------------------------------------
    def load(self, suffix: str = LATEST_SNAPSHOT_SUFFIX) -> Dict[str, Any]:
        if not self._path(suffix).exists() and self._jax_path(suffix).exists():
            raise ValueError(
                f"{self._jax_path(suffix)} is a JAX package snapshot: training cannot resume from "
                "it, because its optax AdamW state does not map onto torch.optim.AdamW's; start "
                "from its params instead (--checkpoint)"
            )
        restored = _read(self._path(suffix))
        meta = {}
        mp = self._meta_path(suffix)
        if mp.exists():
            with open(mp) as f:
                meta = json.load(f)
        self.step = int(meta.get("step", 0))
        self.batch_size = int(meta.get("batch_size", self.batch_size))
        if "metric" in meta:
            self.best_metric = float(meta["metric"])
        logger.info(f"restored checkpoint {self._path(suffix).name} at step {self.step}")
        return {
            "params": restored["params"],
            "opt_state": restored.get("opt_state") if meta.get("has_opt_state", True) else None,
            "step": self.step,
            "batch_size": self.batch_size,
        }

    def rescale_step_for_batch(self, new_global_batch: int) -> int:
        """Resume step rescaling when the global batch size changed
        (reference trainer.py:63-66)."""
        if self.batch_size:
            self.step = (self.step * self.batch_size) // new_global_batch
        self.batch_size = new_global_batch
        return self.step
