"""File + stream logging (reference capability: src/utils/logger.py)."""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Optional, Union

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def get_logger(
    name: str,
    log_dir: Optional[Union[str, Path]] = None,
    stream: bool = True,
    level: int = logging.INFO,
) -> logging.Logger:
    """Create (or fetch) a logger writing to ``<log_dir>/<name>.log`` and stderr.

    The log directory is opt-in (env ``ILI_TPU_LOG_DIR``, shared with the
    JAX package, or an explicit arg).  Loggers live under ``ili_torch.`` so
    the two packages never share handlers in one process.
    """
    logger = logging.getLogger(f"ili_torch.{name}")
    if getattr(logger, "_ili_configured", False):
        return logger
    logger.setLevel(level)
    logger.propagate = False

    formatter = logging.Formatter(_FORMAT)
    if log_dir is None:
        log_dir = os.environ.get("ILI_TPU_LOG_DIR")
    if log_dir:
        path = Path(log_dir)
        path.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(path / f"{name}.log")
        fh.setFormatter(formatter)
        logger.addHandler(fh)
    if stream:
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(formatter)
        logger.addHandler(sh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    logger._ili_configured = True  # type: ignore[attr-defined]
    return logger
