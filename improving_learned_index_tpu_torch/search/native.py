"""ctypes bindings for the C++ native query engine.

Counterpart of ``improving_learned_index_tpu/search/native.py``.  The port
keeps its own byte-equal copy of the engine's source
(``native/impact_engine.cpp``), builds it with ``g++`` into
``build/native/`` at the repository root at first use (never into, or from,
the JAX package's directory), and exposes the same ``score_batch``
interface as the other engines.  Host code: it takes no ``device``.  The
library's file name carries a hash of the source and flags, so an edited
source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Sequence, Set, Tuple, Union

import numpy as np

from ..core.logging import get_logger

logger = get_logger("native_engine", stream=False)

SOURCE = Path(__file__).resolve().parent.parent / "native" / "impact_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXXFLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXXFLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libimpact_engine-{digest}.so"


def build_library(force: bool = False) -> Path:
    """Compile the engine unless a build of this source exists; written to a
    temporary name and renamed into place, so a concurrent or interrupted
    build never leaves a torn library."""
    out = library_path()
    if out.exists() and not force:
        return out
    logger.info("building native impact engine (g++)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_library()))
    lib.ili_open.argtypes = [ctypes.c_char_p]
    lib.ili_open.restype = ctypes.c_void_p
    lib.ili_close.argtypes = [ctypes.c_void_p]
    lib.ili_num_terms.argtypes = [ctypes.c_void_p]
    lib.ili_num_terms.restype = ctypes.c_int64
    lib.ili_num_docs.argtypes = [ctypes.c_void_p]
    lib.ili_num_docs.restype = ctypes.c_int64
    lib.ili_term_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.ili_term_id.restype = ctypes.c_int64
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    lib.ili_score.argtypes = [
        ctypes.c_void_p, i64p, ctypes.c_int64, ctypes.c_int64, u32p, u32p,
    ]
    lib.ili_score.restype = ctypes.c_int64
    lib.ili_score_batch.argtypes = [
        ctypes.c_void_p, i64p, i64p, ctypes.c_int64, ctypes.c_int64, u32p, u32p, i64p,
    ]
    lib.ili_score_batch.restype = ctypes.c_int64
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError):
        return False


class NativeSearchEngine:
    """Query the on-disk binary index through the C++ engine."""

    def __init__(self, index_path: Union[str, Path]):
        self._lib = _load()
        self._handle = self._lib.ili_open(str(index_path).encode())
        if not self._handle:
            raise IOError(f"native engine failed to open index at {index_path}")

    def close(self):
        if getattr(self, "_handle", None):  # None too when __init__ failed
            self._lib.ili_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    @property
    def num_terms(self) -> int:
        return self._lib.ili_num_terms(self._handle)

    @property
    def num_docs(self) -> int:
        return self._lib.ili_num_docs(self._handle)

    def term_id(self, term: str) -> int:
        return self._lib.ili_term_id(self._handle, term.encode())

    def score_batch(
        self, query_term_sets: Sequence[Set[str]], top_k: int = 1000
    ) -> List[List[Tuple[int, float]]]:
        nq = len(query_term_sets)
        if nq == 0:
            return []
        flat: List[int] = []
        offsets = [0]
        for terms in query_term_sets:
            flat.extend(self.term_id(t) for t in terms)
            offsets.append(len(flat))
        term_ids = np.asarray(flat if flat else [0], dtype=np.int64)
        query_offsets = np.asarray(offsets, dtype=np.int64)
        out_docs = np.zeros(nq * top_k, dtype=np.uint32)
        out_scores = np.zeros(nq * top_k, dtype=np.uint32)
        out_counts = np.zeros(nq, dtype=np.int64)
        self._lib.ili_score_batch(
            self._handle, term_ids, query_offsets, nq, top_k, out_docs, out_scores, out_counts
        )
        results = []
        for q in range(nq):
            k = int(out_counts[q])
            base = q * top_k
            results.append(list(zip(out_docs[base : base + k].tolist(),
                                    out_scores[base : base + k].astype(np.float64).tolist())))
        return results
