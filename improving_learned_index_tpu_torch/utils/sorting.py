"""Stable radix argsort for wide non-negative integer keys.

numpy's ``argsort(kind="stable")`` is only a true radix sort for <=16-bit
integer dtypes (~0.9s per 44M keys); int32/int64 keys fall back to a
comparison sort (~9s per 44M).  Composite posting keys (term*256+impact,
shard/block keys) routinely exceed 16 bits, so this decomposes the key into
16-bit digits and chains numpy's fast path LSD-style — stability carries
lower digits (and the caller's input order) through each pass.
"""

from __future__ import annotations

import numpy as np


def radix_argsort(key: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative integer ``key`` via 16-bit passes.
    Equivalent to ``np.argsort(key, kind="stable")``; 2-5x faster once keys
    exceed 16 bits."""
    key = np.asarray(key)
    n = len(key)
    if n == 0:
        return np.empty(0, np.int64)
    mx = int(key.max())
    if mx < (1 << 8):
        return np.argsort(key.astype(np.uint8), kind="stable")
    if mx < (1 << 16):
        return np.argsort(key.astype(np.uint16), kind="stable")
    perm = np.argsort((key & 0xFFFF).astype(np.uint16), kind="stable")
    shift = 16
    while mx >> shift:
        digit = ((key >> shift) & 0xFFFF).astype(np.uint16)
        perm = perm[np.argsort(digit[perm], kind="stable")]
        shift += 16
    return perm
