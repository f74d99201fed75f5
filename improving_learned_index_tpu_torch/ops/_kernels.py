"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source under ``csrc/`` with a plain C interface.  It is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/`` at the
repository root, at first use, and loaded with ``ctypes``: no PyTorch headers,
so a build takes seconds.  The library's file name carries a hash of its
source and flags, so an edited source is rebuilt and never confused with a
stale build.  Nothing here runs at import time: the CPU tests import every
module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from contextlib import nullcontext
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return str(path)


class CudaKernel:
    """One kernel library: its source, the C functions it exports, and the
    number of times the port launched it.

    ``functions`` maps each exported C function to its ``argtypes``; every C
    function returns the ``cudaError_t`` of its launch as an int.
    ``calls`` counts launches by C function: each wrapper adds one where it
    launches the kernel, so a run can show that its path went through the
    kernel (``calls.clear()`` resets it); ``launches`` is their sum.
    """

    def __init__(self, name: str, functions: Dict[str, Sequence]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.functions = dict(functions)
        self.calls: Dict[str, int] = {}
        self._lib = None

    @property
    def launches(self) -> int:
        return sum(self.calls.values())

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def compile_command(self, out: Path) -> List[str]:
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def lib(self):
        """The loaded library, built first if no build of this source exists."""
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.library_path()))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args, device: Optional[torch.device] = None) -> None:
        """Launch through C function ``fn``, with ``device`` (the operands'
        card) current: the launchers set attributes of, and launch on, the
        current device.  Raise on a refused launch."""
        with torch.cuda.device(device) if device is not None else nullcontext():
            err = getattr(self.lib(), fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: {fn} launch failed with cudaError {err}")
        self.calls[fn] = self.calls.get(fn, 0) + 1


def build(kernels: Iterable[CudaKernel]) -> None:
    """Compile every kernel that has no build yet, one ``nvcc`` per source,
    all started together.  Each writes to a temporary name and is renamed
    into place, so a concurrent or interrupted build never leaves a torn
    library behind."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        out = k.library_path()
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs.append((k, out, tmp, subprocess.Popen(
            k.compile_command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    failed = []
    for k, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{k.source.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
