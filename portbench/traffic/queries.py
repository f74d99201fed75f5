"""Query text over an index's terms: the general query generator.

Parameters (a workload's ``traffic``): ``lengths`` (terms a query -> share),
``zipf_s`` (terms drawn Zipf(s) over the terms ranked by frequency, as
``benchmarks/serve_bench.py`` draws them; rewritten here, not imported).

Every seed gets the same multiset of query lengths and nearly the same
spread of term ranks: lengths come from the stated shares in fixed
proportions, term ranks from stratified draws of the Zipf law; the seed
picks the draws inside each stratum and the order.  So two seeds do the
same amount of work in another order.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def stratified_lengths(n: int, shares: Dict, rng: np.random.Generator) -> np.ndarray:
    """``n`` lengths in the stated proportions (largest remainders), shuffled."""
    keys = sorted(int(k) for k in shares)
    p = np.array([float(shares[str(k)] if str(k) in shares else shares[k]) for k in keys])
    p = p / p.sum()
    counts = np.floor(p * n).astype(int)
    rest = n - counts.sum()
    counts[np.argsort(-(p * n - counts), kind="stable")[:rest]] += 1
    out = np.repeat(keys, counts)
    rng.shuffle(out)
    return out


def zipf_ranks(n: int, n_terms: int, s: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` ranks in 0..n_terms-1 under Zipf(s), one stratified uniform
    draw each, shuffled."""
    cdf = np.cumsum(1.0 / np.arange(1, n_terms + 1) ** s)
    cdf /= cdf[-1]
    u = (np.arange(n) + rng.random(n)) / n
    ranks = np.minimum(np.searchsorted(cdf, u, side="right"), n_terms - 1)
    rng.shuffle(ranks)
    return ranks


def make_queries(n: int, terms: List[str], traffic: Dict, seed: int, stream: int = 0) -> List[List[int]]:
    """``n`` queries as lists of distinct term ranks, from ``(seed, stream)``."""
    rng = np.random.default_rng([int(seed), 1, stream])
    lengths = stratified_lengths(n, traffic["lengths"], rng)
    pool = zipf_ranks(int(lengths.sum()) * 2, len(terms), float(traffic["zipf_s"]), rng)
    out, at = [], 0
    for length in lengths:
        q: List[int] = []
        while len(q) < length:
            if at == len(pool):  # a repeat took a draw: draw more
                pool = zipf_ranks(len(pool), len(terms), float(traffic["zipf_s"]), rng)
                at = 0
            t = int(pool[at])
            at += 1
            if t not in q:
                q.append(t)
        out.append(q)
    return out


def query_text(query: List[int], terms: List[str]) -> str:
    return " ".join(terms[t] for t in query)
