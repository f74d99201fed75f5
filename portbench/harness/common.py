"""What every run shares: where things are, the environment, the chip check,
the import guard, the set-up clock, file loading by name, and the result
line.

Nothing here imports torch or the program at import time.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH = ROOT / "portbench"
PROGRAM = "improving_learned_index_tpu_torch"
# top-level module names no run may load: JAX, its libraries, and the JAX
# package (whose name the program's name begins with)
FORBIDDEN = ("jax", "jaxlib", "flax", "improving_learned_index_tpu")


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every module
    loaded in this process), each compared whole: the part before the first
    dot."""
    names = sys.modules if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def set_environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX.  The program builds its own kernels into
    ``build/kernels`` at the checkout's root, a path it fixes in code."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock, from its start
    time in /proc (clock ticks since boot); the time this module was first
    imported where /proc is missing."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - since
    except (OSError, ValueError, IndexError, AttributeError):
        return _IMPORTED


_IMPORTED = time.monotonic()


def load_json(path: Path) -> Any:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """A Python file of the benchmark, loaded by its path (metric readers'
    names hold dots, so they are not importable by name)."""
    spec = importlib.util.spec_from_file_location(name or f"portbench_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes."""

    name: str
    value: float
    limit: float

    @property
    def passed(self) -> bool:
        return isinstance(self.value, (int, float)) and not math.isnan(self.value) and self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back: the work attempted and failed, its
    end-to-end numbers, the checks of its output, and what the metric
    readers read in a traced run."""

    attempted: int
    failed: int
    metrics: Dict[str, float]
    checks: List[Check]
    memory_peak_bytes: int
    readings: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Cell:
    """One run of one cell: its entries and files, the run's arguments, and
    the set-up clock."""

    name: str
    seed: int
    seconds: float
    trace: bool
    device: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    tmpdir: Path
    started: float
    window_start: Optional[float] = None
    host_start: Optional[Dict[str, Any]] = None

    def open_window(self) -> float:
        """Mark the first timed operation; set-up ends here.  Set-up must
        not have loaded JAX or the JAX package."""
        found = forbidden_modules()
        if found:
            raise RuntimeError(f"forbidden modules loaded by set-up: {found}")
        self.host_start = host_state()
        self.window_start = time.monotonic()
        return self.window_start

    def close_window(self) -> float:
        """Mark the end of the timed work, and log the cores this process
        kept busy over the window (see ``host_window``)."""
        t = time.monotonic()
        if self.host_start is not None:
            log(f"host over the window: {json.dumps(host_window(self.host_start, host_state()))}")
        return t

    @property
    def setup_s(self) -> float:
        if self.window_start is None:
            raise RuntimeError("the window never opened")
        return self.window_start - self.started

    def limit(self, name: str) -> float:
        return float(self.workload["limits"][name])


def host_state() -> Dict[str, float]:
    """This process's CPU time (all its threads) and the clock now."""
    return {"process_s": time.process_time(), "wall_s": time.monotonic()}


def host_window(start: Dict[str, float], end: Dict[str, float]) -> Dict[str, float]:
    """Between two ``host_state`` readings: the seconds, and the cores this
    process kept busy (its CPU time over the wall time).  The card's
    machine is a sandbox whose /proc/stat and load average are not the
    host's, so that is all a run can read of the host."""
    wall = end["wall_s"] - start["wall_s"]
    return {"wall_s": wall, "process_cores": (end["process_s"] - start["process_s"]) / wall if wall > 0 else None}


def result_line(outcome: Outcome, metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                breakdown: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    line = {
        "correct": all(c.passed for c in outcome.checks) and bool(outcome.checks),
        "attempted": int(outcome.attempted),
        "failed": int(outcome.failed),
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def emit(line: Dict[str, Any], checks: List[Check]) -> None:
    """The result as the last line of standard output, and each number
    compared beside its limit as the last lines of standard error."""
    sys.stdout.flush()
    for c in checks:
        print(f"check {c.name}: {c.value} (limit {c.limit}) {'pass' if c.passed else 'FAIL'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)
