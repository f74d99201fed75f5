"""BM25 baseline scorer.

The reference delegates its classical baseline to PyTerrier/Terrier (JVM;
src/llama2/evaluation/evaluate.py:131-217).  Here BM25 is native: postings
built with the same pluggable tokenizer, scored vectorized in numpy.  Used
as the sanity baseline for expansion quality (SURVEY.md §4.3).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Set, Tuple

import numpy as np


class BM25Index:
    def __init__(self, k1: float = 1.2, b: float = 0.75):
        self.k1 = k1
        self.b = b
        self.doc_ids: List[str] = []
        self.postings: Dict[str, List[Tuple[int, int]]] = {}
        self.doc_lens: List[int] = []
        self.avgdl: float = 0.0

    def build(self, corpus: Iterable[Tuple[str, str]], tokenizer) -> "BM25Index":
        """corpus: (doc_id, text) pairs; tokenizer provides process_query()
        for term extraction (consistent with the impact pipeline)."""
        for doc_id, text in corpus:
            terms = list(tokenizer.segmenter(text)) if hasattr(tokenizer, "segmenter") else list(
                tokenizer.process_query(text)
            )
            idx = len(self.doc_ids)
            self.doc_ids.append(doc_id)
            counts = Counter(t for t in terms)
            self.doc_lens.append(sum(counts.values()))
            for term, tf in counts.items():
                self.postings.setdefault(term, []).append((idx, tf))
        self.avgdl = float(np.mean(self.doc_lens)) if self.doc_lens else 0.0
        return self

    def idf(self, term: str) -> float:
        n = len(self.doc_ids)
        df = len(self.postings.get(term, ()))
        # Robertson-Sparck Jones idf with +0.5 smoothing (Terrier default family)
        return math.log(1 + (n - df + 0.5) / (df + 0.5))

    def score(self, query_terms: Set[str], top_k: int = 1000) -> List[Tuple[str, float]]:
        scores = np.zeros(len(self.doc_ids), dtype=np.float64)
        dl = np.asarray(self.doc_lens, dtype=np.float64)
        norm = self.k1 * (1 - self.b + self.b * dl / max(self.avgdl, 1e-9))
        for term in query_terms:
            plist = self.postings.get(term)
            if not plist:
                continue
            idf = self.idf(term)
            idxs = np.fromiter((i for i, _ in plist), dtype=np.int64, count=len(plist))
            tfs = np.fromiter((tf for _, tf in plist), dtype=np.float64, count=len(plist))
            scores[idxs] += idf * tfs * (self.k1 + 1) / (tfs + norm[idxs])
        k = min(top_k, int(np.count_nonzero(scores)))
        if k == 0:
            return []
        top = np.argpartition(scores, -k)[-k:]
        top = top[np.argsort(-scores[top], kind="stable")]
        return [(self.doc_ids[i], float(scores[i])) for i in top]

    def search(
        self, queries: Dict[str, str], tokenizer, top_k: int = 1000
    ) -> Dict[str, Dict[str, float]]:
        results = {}
        for qid, query in queries.items():
            terms = tokenizer.process_query(query)
            results[qid] = dict(self.score(terms, top_k))
        return results
