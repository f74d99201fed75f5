"""The device trace of a window: ``torch.profiler`` over it, read into the
device's busy time, device time by operation, by the program's module and
by named region, and the idle gaps by what the host was doing.

Every thread is profiled.  A kernel is given to a layer in one of two
ways.  A kernel of the program's own CUDA sources (``csrc/*.cu``) is known
by its name, found among the ``__global__`` functions of those sources.
Any kernel belongs to a named region (``record_function``: the program's
own annotations, or the benchmark's spans around its calls into a layer)
when its launch, a runtime call with the kernel's correlation id, falls
inside the region on the region's thread.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .common import PROGRAM, ROOT

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)\s*\(")


def kernel_sources() -> Dict[str, str]:
    """Each ``__global__`` function of the program's CUDA sources -> its
    source, relative to the package (``csrc/gather_rows.cu``)."""
    out = {}
    for path in sorted((ROOT / PROGRAM / "csrc").glob("*.cu")):
        for name in _GLOBAL.findall(path.read_text(encoding="utf-8", errors="replace")):
            out[name] = f"csrc/{path.name}"
    return out


@dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float
    files: frozenset  # the program's CUDA source that holds the kernel, if any
    regions: frozenset = frozenset()  # the named regions it was launched inside


@dataclass
class Profile:
    """One traced window."""

    window_s: float
    ops: List[DeviceOp]
    host: List[Tuple[float, float, str]]  # (start_us, end_us, name) of host events
    units: int = 0  # batches or steps the window held, set by the cell's traffic code

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _merged((o.start_us, o.end_us) for o in self.ops)) / 1e6

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def device_s(self, files: Iterable[str] = (), regions: Iterable[str] = ()) -> float:
        """Device seconds of the ops that the program's CUDA ``files`` hold
        or that were launched inside any of the named ``regions``."""
        files, regions = set(files), set(regions)
        return sum(o.end_us - o.start_us for o in self.ops if o.files & files or o.regions & regions) / 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        by = {}
        for o in self.ops:
            by[o.name[:120]] = by.get(o.name[:120], 0.0) + (o.end_us - o.start_us) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10, min_us: float = 5.0) -> List[list]:
        """Idle time between device ops, summed by the innermost host event
        that covers each gap's middle."""
        spans = _merged((o.start_us, o.end_us) for o in self.ops)
        host = sorted(self.host)
        starts = [h[0] for h in host]
        by: Dict[str, float] = {}
        for (_, e0), (s1, _) in zip(spans, spans[1:]):
            if s1 - e0 < min_us:
                continue
            mid = (e0 + s1) / 2
            label = "host: no traced event"
            # the latest-starting host event that still covers the middle
            for i in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 5000), -1):
                if host[i][1] >= mid:
                    label = host[i][2]
                    break
            by[label] = by.get(label, 0.0) + (s1 - e0) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def _merged(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Window:
    """``with Window(annotations=...) as w:`` profiles the block;
    ``w.profile`` is the reading.  The block should end with the device's
    work done (the caller synchronizes)."""

    def __init__(self, annotations: Sequence[str] = (), all_threads: bool = True):
        self.all_threads = all_threads
        self.annotations = tuple(annotations)
        self.profile: Optional[Profile] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._cuda = torch.cuda.is_available()
        if self._cuda:
            torch.cuda.synchronize()
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self._cuda else [])
        extra = {}
        if self.all_threads:
            try:  # every thread: autograd and loader threads of the caller's
                from torch._C._profiler import _ExperimentalConfig

                extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
            except (ImportError, TypeError):
                pass
        self._prof = profile(activities=activities, **extra)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        if self._cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.profile = read(self._prof, wall, self.annotations)
        return False


def read(prof, window_s: float, annotations: Sequence[str] = ()) -> Profile:
    from torch.autograd import DeviceType

    events = list(prof.events())
    sources = kernel_sources()
    by_name = re.compile(r"\b(" + "|".join(map(re.escape, sources)) + r")\b") if sources else None
    host, spans, launches = [], [], {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if not getattr(e, "is_async", False):
            host.append((e.time_range.start, e.time_range.end, e.name[:80]))
        if e.name in annotations:
            spans.append((e.name, e.thread, e.time_range.start, e.time_range.end))
        elif e.name.startswith("cu"):  # a runtime or driver call: its id is the launch's correlation
            launches[e.id] = (e.thread, e.time_range.start)
    ops = []
    for e in events:
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        if e.name in annotations or e.name.startswith("ProfilerStep"):
            continue
        found = by_name.search(e.name) if by_name is not None else None
        files = frozenset([sources[found.group(1)]]) if found else frozenset()
        at = launches.get(e.id)
        inside = frozenset(name for name, thread, s0, s1 in spans
                           if at is not None and at[0] == thread and s0 <= at[1] <= s1)
        ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end, files, inside))
    return Profile(window_s=window_s, ops=ops, host=host)
