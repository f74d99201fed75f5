"""Tracing / profiling hooks.

Counterpart of ``improving_learned_index_tpu/core/profiling.py`` on
``torch.profiler``: ``trace`` writes a chrome trace (``trace.json``, open it
in Perfetto or ``chrome://tracing``) for a block, and ``annotate`` names a
region inside one.  The card's activity is traced where a CUDA device is
present.

``annotate`` is cheap enough for the hot loops: with no profiler running it
enters nothing.  A region is a ``record_function`` event, on the same clock
as the card's activity in the same trace; the program keeps no clock of its
own.  The port's regions, each on the thread that drives the card:

- search: ``search/stage_inputs``, ``search/topk``, ``search/topk_sync``
  (one a convergence test of the top-k's search, each a host sync),
  ``search/result_wait``, ``search/answers``, and ``text/process_query``
  once a query;
- index: ``index/next_batch`` (the wait on the tokenizer thread),
  ``index/encode``, ``index/scores_to_host``, ``index/write``;
- train: ``train/next_batch``, ``train/put_batch``, ``train/forward``,
  ``train/backward``, ``train/optimizer``, ``train/step_end``;
- encoder: one region a ``TransformerEncoder`` forward, named by its
  attention route: ``encoder/route_short``, ``encoder/route_flash`` or
  ``encoder/route_plain`` (inside ``index/encode`` or ``train/forward``).

No region name starts with ``cu``, which trace readers take for CUDA
runtime calls.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Union

import torch
from torch.autograd import profiler as _autograd_profiler

from .logging import get_logger

logger = get_logger("profiling", stream=False)

_NO_REGION = contextlib.nullcontext()


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
    """Named region inside a trace: ``torch.profiler.record_function(name)``
    while a profiler runs, else one shared no-op context.

    The test is torch's process-wide flag, set while any ``torch.profiler``
    profile is on.  ``torch.autograd._profiler_enabled()`` is thread-local
    and reads False on every thread, the profiling one too, when a profile
    traces all threads (``_ExperimentalConfig(profile_all_threads=True)``).
    So call it only on a thread whose regions are wanted."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_REGION
