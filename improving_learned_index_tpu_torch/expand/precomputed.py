"""Expansion from *precomputed* query stores (doc2query-- and TILDE).

Counterpart of ``improving_learned_index_tpu/expand/precomputed.py`` (host
numpy and Python, the port's own copy on the port's ``CollectionParser`` and
``get_unique_query_terms``), capability parity with:
- reference src/doc2query--/expand_filter_precomputed.py:23-64 — per-doc
  precomputed (query, relevance-score) lists filtered by a **global score
  percentile** threshold, then appended either as full queries or as unique
  novel terms, separated from the document by `` [SEP] ``;
- reference src/tilde_expansions/create_expanded_collection.py:9-29 —
  append non-duplicate precomputed TILDE terms after `` [SEP]``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple, Union

import numpy as np

from ..core.logging import get_logger
from ..data.datasets import CollectionParser
from ..utils.text_utils import get_unique_query_terms

logger = get_logger("precomputed_expansion", stream=False)


def score_percentile_threshold(
    scored_queries: Dict[str, List[Tuple[str, float]]], percentile: float
) -> float:
    """Global threshold: the given percentile over ALL query scores
    (reference expand_filter_precomputed.py:38,49-51)."""
    all_scores = [s for qs in scored_queries.values() for _, s in qs]
    if not all_scores:
        return float("-inf")
    return float(np.percentile(np.asarray(all_scores, dtype=np.float64), percentile))


def expand_with_precomputed(
    collection_path: Union[str, Path],
    scored_queries: Dict[str, List[Tuple[str, float]]],
    output_path: Union[str, Path],
    tokenizer,
    percentile: float = 30.0,
    append: str = "terms",  # "terms" = unique novel terms | "queries" = full queries
    collection_type: str = "msmarco",
) -> int:
    threshold = score_percentile_threshold(scored_queries, percentile)
    logger.info(f"score threshold at p{percentile}: {threshold:.4f}")
    n = 0
    with open(collection_path, encoding="utf-8") as f, open(
        output_path, "w", encoding="utf-8"
    ) as out:
        for line in f:
            if not line.strip():
                continue
            doc_id, doc = CollectionParser.parse(line, collection_type)
            kept = [q for q, s in scored_queries.get(doc_id, []) if s >= threshold]
            if append == "queries":
                suffix = " ".join(kept)
            else:
                suffix = " ".join(get_unique_query_terms(kept, doc, tokenizer)) if kept else ""
            text = f"{doc} [SEP] {suffix}".strip() if suffix else doc
            out.write(f"{doc_id}\t{text}\n")
            n += 1
    return n


def tilde_expand(
    collection_path: Union[str, Path],
    tilde_terms: Dict[str, Sequence[str]],
    output_path: Union[str, Path],
    tokenizer,
    collection_type: str = "msmarco",
) -> int:
    """Append non-duplicate TILDE terms after `` [SEP]``
    (reference tilde_expansions/create_expanded_collection.py:16-29)."""
    n = 0
    with open(collection_path, encoding="utf-8") as f, open(
        output_path, "w", encoding="utf-8"
    ) as out:
        for line in f:
            if not line.strip():
                continue
            doc_id, doc = CollectionParser.parse(line, collection_type)
            doc_terms = tokenizer.process_query(doc)
            novel = [t for t in tilde_terms.get(doc_id, []) if t not in doc_terms]
            text = f"{doc} [SEP] {' '.join(novel)}".strip() if novel else doc
            out.write(f"{doc_id}\t{text}\n")
            n += 1
    return n


def load_scored_queries_jsonl(path: Union[str, Path]) -> Dict[str, List[Tuple[str, float]]]:
    """JSONL: {"doc_id", "queries": [{"query", "score"}, ...]} or
    {"doc_id", "queries": [str], "scores": [float]}."""
    out: Dict[str, List[Tuple[str, float]]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            e = json.loads(line)
            qs = e.get("queries", [])
            if qs and isinstance(qs[0], dict):
                out[str(e["doc_id"])] = [(q["query"], float(q["score"])) for q in qs]
            else:
                scores = e.get("scores", [0.0] * len(qs))
                out[str(e["doc_id"])] = list(zip(qs, map(float, scores)))
    return out
