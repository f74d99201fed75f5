"""Tracing / profiling hooks.

Counterpart of ``improving_learned_index_tpu/core/profiling.py`` on
``torch.profiler``: ``trace`` writes a chrome trace (``trace.json``, open it
in Perfetto or ``chrome://tracing``) for a block, ``annotate`` names a
region inside one (``record_function``), ``ScheduledTracer`` follows the
reference's wait/warmup/active schedule (src/llama2/finetune/finetune.py:84-96)
and ``ThroughputMeter`` counts items/s (reference passages/s logging,
src/deep_impact/index.py:37).  The card's activity is traced where a CUDA
device is present.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Union

import torch

from .logging import get_logger

logger = get_logger("profiling", stream=False)


def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: Union[str, Path], enabled: bool = True) -> Iterator[None]:
    """Capture a torch.profiler trace of the enclosed block as
    ``<log_dir>/trace.json``."""
    if not enabled:
        yield
        return
    from torch.profiler import profile

    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield
    prof.export_chrome_trace(str(path / "trace.json"))
    logger.info(f"profiler trace written to {path / 'trace.json'}")


def annotate(name: str):
    """Named region inside a trace (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class ScheduledTracer:
    """wait/warmup/active/repeat stepping (the reference's torch.profiler
    schedule, finetune.py:87-90): call ``step()`` once per training step;
    each active window is written as ``<log_dir>/trace_<step>.json``."""

    def __init__(
        self,
        log_dir: Union[str, Path],
        wait: int = 1,
        warmup: int = 1,
        active: int = 2,
        repeat: int = 1,
        enabled: bool = True,
    ):
        self.log_dir = Path(log_dir)
        self._prof = None
        if enabled:
            from torch.profiler import profile, schedule

            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._prof = profile(
                activities=_activities(),
                schedule=schedule(wait=wait, warmup=warmup, active=active, repeat=repeat),
                on_trace_ready=self._write,
            )
            self._prof.start()

    def _write(self, prof) -> None:
        prof.export_chrome_trace(str(self.log_dir / f"trace_{prof.step_num}.json"))

    def step(self) -> None:
        if self._prof is not None:
            self._prof.step()

    def close(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None


class ThroughputMeter:
    """Rolling items/s counter (reference passages/s logging, index.py:37)."""

    def __init__(self, name: str = "items"):
        self.name = name
        self.start = time.time()
        self.count = 0

    def update(self, n: int) -> None:
        self.count += n

    @property
    def rate(self) -> float:
        elapsed = time.time() - self.start
        return self.count / elapsed if elapsed > 0 else 0.0

    def log(self) -> str:
        msg = f"{self.count} {self.name} [{self.rate:.2f} {self.name}/s]"
        logger.info(msg)
        return msg
