"""Query-term helpers (reference src/utils/utils.py:6-23).

``merge_document_and_queries`` appends only the query terms that are
*novel* with respect to the document, with underscores (from compound-word
segmenters) replaced by spaces and whitespace collapsed; the ranker's
``expand_pairwise_terms`` builds the pairwise index's composite terms.
"""

from __future__ import annotations

import re
from typing import List, Set


def get_unique_query_terms(query_list: List[str], passage: str, tokenizer) -> Set[str]:
    """Terms present in the generated queries but not in the passage, using
    the same query processor on both sides for consistency."""
    query_terms = tokenizer.process_query(" ".join(query_list))
    passage_terms = tokenizer.process_query(passage)
    return query_terms.difference(passage_terms)


def merge_document_and_queries(document: str, queries: List[str], tokenizer) -> str:
    document = document.replace("\n", " ")
    unique_terms = " ".join(get_unique_query_terms(queries, document, tokenizer))
    unique_terms = unique_terms.replace("_", " ")
    return re.sub(r"\s{2,}", " ", f"{document} {unique_terms}").strip()


def expand_pairwise_terms(terms: Set[str]) -> Set[str]:
    """Add ``term1|term2`` composite postings terms for every ordered pair —
    the pairwise-impact index convention (reference ranker.py:53-57)."""
    snapshot = list(terms)
    for t1 in snapshot:
        for t2 in snapshot:
            if t1 != t2:
                terms.add(f"{t1}|{t2}")
    return terms
