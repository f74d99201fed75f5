"""Query-term helpers shared by the ranker (reference src/utils/utils.py)."""

from __future__ import annotations

from typing import Set


def expand_pairwise_terms(terms: Set[str]) -> Set[str]:
    """Add ``term1|term2`` composite postings terms for every ordered pair —
    the pairwise-impact index convention (reference ranker.py:53-57)."""
    snapshot = list(terms)
    for t1 in snapshot:
        for t2 in snapshot:
            if t1 != t2:
                terms.add(f"{t1}|{t2}")
    return terms
