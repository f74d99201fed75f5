"""Impact quantization: global-max linear scale to b-bit integers.

The port's copy of ``improving_learned_index_tpu/ops/quantize.py``, with
exact semantic parity to the reference 2-pass scheme
(src/deep_impact/indexing/quantize.py:13-47): ``scale = (2^b - 1) / max``,
``q = int(score * scale)`` (truncation toward zero), terms quantizing to 0
are dropped.  The host path uses float64 like CPython; ``quantize_device``
is the same formula as a torch function for scores already on the card.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from ..core.config import IMPACT_SCORE_QUANTIZATION_BITS


def quantize_scale(max_val: float, bits: int = IMPACT_SCORE_QUANTIZATION_BITS) -> float:
    return ((1 << bits) - 1) / max_val


def quantize_value(value: float, scale: float) -> int:
    return int(value * scale)


def quantize_array(values: np.ndarray, scale: float) -> np.ndarray:
    """Vectorized host quantization (float64, truncation)."""
    return np.trunc(np.asarray(values, dtype=np.float64) * scale).astype(np.int64)


def quantize_device(values: torch.Tensor, scale) -> torch.Tensor:
    """Device quantization: trunc(score * scale) as int32, in fp32 as the
    JAX function computes it.  Scores are non-negative (ReLU/Softplus heads)
    so trunc == floor."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=values.device)
    return torch.floor(values.to(torch.float32) * scale).to(torch.int32)


def global_max(chunks: Iterable[np.ndarray]) -> float:
    """Pass 1: global max over impact score chunks."""
    m = 0.0
    for c in chunks:
        if c.size:
            m = max(m, float(np.max(c)))
    return m
