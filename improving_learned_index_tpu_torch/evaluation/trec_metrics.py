"""TREC-style retrieval metrics: NDCG / MAP / Recall / P @ k.

Drop-in for what the reference obtains from ``beir.retrieval.evaluation.
EvaluateRetrieval.evaluate`` (reference nano_beir_evaluator.py:230-232),
which wraps pytrec_eval: graded-gain NDCG with log2 discount, MAP with the
full-relevant denominator, recall against all relevant docs, precision at
cutoff.  Implemented in numpy — no external eval dependency, and the per-k
accumulation is prefix-sum vectorized (one O(R) pass per query instead of
O(R x |k_values|) Python loops).

Score ties break by doc id DESCENDING, matching pytrec_eval/trec_eval (they
sort (score, doc_id) pairs descending), so metrics agree with the reference
at tied-score boundaries.

Inputs match the beir calling convention:
    qrels   : {qid: {doc_id: relevance}}
    results : {qid: {doc_id: score}}
    k_values: [10, 100, 1000]
Returns the beir 4-tuple of dicts: (ndcg, map, recall, precision).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _sorted_docs(result: Dict[str, float]) -> List[str]:
    # trec_eval tie-break: score desc, then doc id DESC (pytrec_eval sorts
    # (score, doc_id) tuples in reverse).  Two-pass stable sort: doc id desc,
    # then score desc.
    docs = sorted(result, reverse=True)
    docs.sort(key=result.__getitem__, reverse=True)
    return docs


def evaluate(
    qrels: Dict[str, Dict[str, int]],
    results: Dict[str, Dict[str, float]],
    k_values: Sequence[int] = (10, 100, 1000),
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, float], Dict[str, float]]:
    ndcg = {f"NDCG@{k}": 0.0 for k in k_values}
    _map = {f"MAP@{k}": 0.0 for k in k_values}
    recall = {f"Recall@{k}": 0.0 for k in k_values}
    precision = {f"P@{k}": 0.0 for k in k_values}
    ks = np.asarray(k_values, dtype=np.int64)

    num_q = 0
    for qid, rel_docs in qrels.items():
        rels = {d: r for d, r in rel_docs.items() if r > 0}
        if not rels:
            continue
        num_q += 1
        ranked = _sorted_docs(results.get(qid, {}))
        gains = np.asarray([rels.get(d, 0) for d in ranked], dtype=np.float64)
        total_rel = len(rels)
        n = len(gains)

        # Prefix sums over the ranked list; metric@k = prefix[min(k, n)].
        discounts = 1.0 / np.log2(np.arange(2, n + 2))
        dcg_pref = np.concatenate([[0.0], np.cumsum(gains * discounts)])
        hit = (gains > 0).astype(np.float64)
        hits_pref = np.concatenate([[0.0], np.cumsum(hit)])
        # AP contributions: hits_so_far / rank at each relevant position.
        ap_pref = np.concatenate(
            [[0.0], np.cumsum(hit * hits_pref[1:] / np.arange(1, n + 1))]
        )

        ideal = np.sort(np.asarray(list(rels.values()), dtype=np.float64))[::-1]
        idcg_pref = np.concatenate(
            [[0.0], np.cumsum(ideal / np.log2(np.arange(2, len(ideal) + 2)))]
        )

        cut = np.minimum(ks, n)
        icut = np.minimum(ks, len(ideal))
        for j, k in enumerate(k_values):
            idcg = idcg_pref[icut[j]]
            ndcg[f"NDCG@{k}"] += dcg_pref[cut[j]] / idcg if idcg > 0 else 0.0
            _map[f"MAP@{k}"] += ap_pref[cut[j]] / total_rel
            recall[f"Recall@{k}"] += hits_pref[cut[j]] / total_rel
            precision[f"P@{k}"] += hits_pref[cut[j]] / k

    for d in (ndcg, _map, recall, precision):
        for key in d:
            d[key] = round(d[key] / max(num_q, 1), 5)
    return ndcg, _map, recall, precision
