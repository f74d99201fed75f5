"""Engine construction from a saved index.

Counterpart of ``improving_learned_index_tpu/search/select.py``.  The port
has one engine so far, the hybrid engine, so ``auto`` picks ``hybrid`` at
every corpus size.  The JAX package picks its flat-scatter ``device`` engine
below 4,000 docs; both engines are exact with doc-id tie order, so the
results do not change, only which code computes them.  The threshold comes
back with the port of the device engine.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

ENGINES = ("auto", "hybrid")


def build_engine(
    index_path,
    engine: str = "auto",
    dense_budget_bytes: int = 4 << 30,
    num_docs: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    use_kernels: Optional[bool] = None,
):
    """Construct a query engine from a saved index — the construction path
    shared by the rank CLI and library users.  ``engine``: auto | hybrid.
    ``device``: None means ``cuda``."""
    if engine not in ENGINES:
        raise ValueError(f"unknown or not yet ported engine {engine!r}; choose from {ENGINES}")
    from ..core.config import SearchConfig
    from ..core.device import resolve_device
    from ..core.logging import get_logger
    from ..index.inverted import InvertedIndexData
    from .hybrid_engine import HybridSearchEngine

    dev = resolve_device(device)  # fail before reading a corpus-scale index
    index = InvertedIndexData.load(index_path, num_docs=num_docs)
    if engine == "auto":
        get_logger("select").info(
            f"auto-selected engine 'hybrid' for {int(index.num_docs)} docs"
        )
    return HybridSearchEngine(
        index,
        SearchConfig(),
        dense_budget_bytes=dense_budget_bytes,
        device=dev,
        use_kernels=use_kernels,
    )
