"""Corpus-size-based engine selection and construction from a saved index.

Counterpart of ``improving_learned_index_tpu/search/select.py``.  Engines:

- ``device`` (search.device_engine): flat [Q, num_docs] scatter accumulator,
  on the card.
- ``hybrid`` (search.hybrid_engine): dense heavy-term rows + chunked tail
  scatter + exact integer top-k, on the card.
- ``host`` (search.engine) and ``native`` (search.native): numpy and C++ on
  the host; they take no device.

``choose_engine`` keeps the JAX package's corpus-size thresholds, so
``auto`` picks what it picks there (``device`` below 4,000 docs for a
quantized index).  Every engine returns exact scores with ties in doc-id
order, so the choice changes which code computes a ranking, not the
ranking.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

# Quantized (integer-score) disk indexes — the rank CLI path: the JAX
# package's boundary (its device-vs-hybrid sweep put the hybrid engine ahead
# down to 4k docs, its smallest measured point).
HYBRID_MIN_DOCS_QUANTIZED = 4_000

# Float-impact in-memory corpora (SparseSearch / NanoBEIR in-training eval).
HYBRID_MIN_DOCS = 100_000

ENGINES = ("auto", "device", "hybrid", "host", "native")


def choose_engine(num_docs: int, integer_scores: bool = True) -> str:
    """Return the engine name ("device" | "hybrid") for a corpus of
    ``num_docs`` documents with the given score lattice."""
    bound = HYBRID_MIN_DOCS_QUANTIZED if integer_scores else HYBRID_MIN_DOCS
    return "hybrid" if num_docs >= bound else "device"


def build_engine(
    index_path,
    engine: str = "auto",
    approx_top_k: bool = False,
    dense_budget_bytes: int = 4 << 30,
    num_docs: int = 0,
    device: Optional[Union[str, torch.device]] = None,
):
    """Construct a query engine from a saved index — the construction path
    shared by the rank CLI and library users.  ``engine``: auto | device |
    hybrid | host | native.  ``device`` (card engines only): None means
    ``cuda``.  ``approx_top_k`` raises: the port's top-k is exact."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; choose from {ENGINES}")
    if approx_top_k:
        raise ValueError("approximate top-k is not ported; the port's top-k is exact")
    if engine == "native":
        from .native import NativeSearchEngine

        return NativeSearchEngine(index_path)
    from ..core.config import SearchConfig
    from ..core.device import resolve_device
    from ..core.logging import get_logger
    from ..index.inverted import InvertedIndexData

    if engine != "host":
        device = resolve_device(device)  # fail before reading a corpus-scale index
    index = InvertedIndexData.load(index_path, num_docs=num_docs)
    if engine == "auto":
        engine = choose_engine(int(index.num_docs))
        get_logger("select").info(
            f"auto-selected engine '{engine}' for {int(index.num_docs)} docs"
        )
    if engine == "device":
        from .device_engine import DeviceSearchEngine

        return DeviceSearchEngine(index, SearchConfig(), device=device)
    if engine == "hybrid":
        from .hybrid_engine import HybridSearchEngine

        return HybridSearchEngine(
            index,
            SearchConfig(),
            dense_budget_bytes=dense_budget_bytes,
            device=device,
        )
    from .engine import InvertedIndex

    return InvertedIndex(index)
