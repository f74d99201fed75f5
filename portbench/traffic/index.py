"""A quantized impact index at a stated geometry, made on the device from
the seed: the data of an index configuration.

Copied from ``chip_smoke.py`` (``zipf_counts``, ``make_corpus``) without
its planted query docs.  Term ``t`` (ranked by frequency) holds ``c_t``
distinct docs under Zipf(``zipf_s``) list lengths scaled to the stated
number of postings, one uniform doc in each of ``c_t`` equal strata; each
impact is uniform in 1..2^bits-1; each list is then sorted stably by impact
descending (doc ascending among equal impacts), the order ``cli.invert``
writes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def zipf_counts(n_terms: int, n_postings: int, max_len: int, s: float = 1.0) -> np.ndarray:
    """Per-term posting counts under Zipf(s), each capped at ``max_len``,
    scaled so they sum to about ``n_postings``."""
    w = 1.0 / np.arange(1, n_terms + 1) ** s
    lo, hi = 0.0, float(n_postings) * 10
    for _ in range(100):
        mid = (lo + hi) / 2
        if np.minimum(mid * w, max_len).sum() < n_postings:
            lo = mid
        else:
            hi = mid
    return np.maximum(np.floor(np.minimum(mid * w, max_len)), 1).astype(np.int64)


def term_names(n_terms: int) -> List[str]:
    """The index's terms, by frequency rank: words the query tokenizer keeps
    whole (one run of letters and digits)."""
    return [f"t{i:05d}" for i in range(n_terms)]


def make_index(config: Dict, seed: int, device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(offsets int64 [T+1], doc ids uint32, impacts uint8), host arrays."""
    import torch

    num_docs, n_terms = config["num_docs"], config["num_terms"]
    c = zipf_counts(n_terms, config["num_postings"], num_docs, config.get("zipf_s", 1.0))
    offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(c, out=offsets[1:])
    total = int(offsets[-1])
    top = (1 << config["impact_bits"]) - 1

    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    term_of = torch.repeat_interleave(
        torch.arange(n_terms, device=device), torch.from_numpy(c).to(device), output_size=total
    )
    i = torch.arange(total, device=device) - torch.from_numpy(offsets[:-1]).to(device)[term_of]
    ct = torch.from_numpy(c).to(device)[term_of]
    b0 = (i * num_docs) // ct
    gap = ((i + 1) * num_docs) // ct - b0
    del i, ct
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    doc = b0 + torch.minimum((u * gap).long(), gap - 1)
    del u, b0, gap
    vals = torch.randint(1, top + 1, (total,), generator=g, device=device, dtype=torch.int32).to(torch.uint8)
    order = torch.sort(term_of * (top + 1) + (top - vals.long()), stable=True).indices
    del term_of
    doc, vals = doc[order], vals[order]
    del order
    docs = doc.to(torch.int32).cpu().numpy().view(np.uint32)
    return offsets, docs, vals.cpu().numpy()


def heavy_terms(lengths: np.ndarray, config: Dict) -> np.ndarray:
    """The terms whose dense rows the configuration's memory holds: lists of
    at least ``heavy_min`` postings, longest first, as many bf16 rows of
    ``num_docs`` cells as ``dense_budget_bytes`` holds."""
    rows = max(1, config["dense_budget_bytes"] // (2 * config["num_docs"]))
    tids = np.nonzero(lengths >= config["heavy_min"])[0]
    if len(tids) > rows:
        tids = np.sort(tids[np.argsort(lengths[tids], kind="stable")[::-1][:rows]])
    return tids
