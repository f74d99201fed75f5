"""Reranking of a first-stage top-k list: by impact scores, or by a
cross-encoder.

Counterpart of ``improving_learned_index_tpu/evaluation/reranker.py``
(reference ReRanker, src/deep_impact/evaluation/reranker.py:13-113, and
evaluation/cross_encoder_reranker.py:12-62), with its host logic line for
line, so both packages write the same run file from the same scores:

- ``ReRanker``: for each query, encode its candidates that are not cached
  yet (batches of ``batch_size``; the cache of term impacts lives across
  queries), score a candidate as the sum of its impacts of the query's
  terms (an int 0 for a candidate that matches none), and keep the first
  ``final_k`` of a stable descending sort.
- ``CrossEncoderReRanker``: for each query of a top-k file, score each
  candidate passage (read from the collection, not the top-k file) with
  ``model.score_batch`` in batches of ``batch_size``; a stable descending
  sort.

The encode runs on the model's device (the ``short_attention`` kernel on
the card); scores reach the run file as Python floats.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple, Union

from ..core.logging import get_logger
from ..data.datasets import Collection, Queries, RunFile, TopKDataset, TopKRunFile

logger = get_logger("reranker")


class ReRanker:
    def __init__(
        self,
        model,
        top_k_run_file_path: Union[str, Path],
        queries_path: Union[str, Path],
        collection_path: Union[str, Path],
        output_path: Union[str, Path],
        batch_size: int = 128,
        final_k: int = 1000,
    ):
        self.model = model
        self.top_k = TopKRunFile(top_k_run_file_path)
        self.queries = Queries(queries_path)
        self.collection = Collection(collection_path)
        self.run_file = RunFile(output_path)
        self.batch_size = batch_size
        self.final_k = final_k
        self.cache: Dict[str, Dict[str, float]] = {}

    def _encode(self, pids: List[str]) -> None:
        docs = [self.collection[pid] for pid in pids]
        for pid, term_impacts in zip(pids, self.model.get_impact_scores_batch(docs)):
            self.cache[pid] = dict(term_impacts)

    def score(self, pid: str, query_terms) -> float:
        return sum(self.cache[pid].get(t, 0) for t in query_terms)

    def rerank(self, qid: str, pids: List[str]) -> List[Tuple[str, float]]:
        query_terms = self.model.process_query(self.queries[qid])
        missing = [pid for pid in pids if pid not in self.cache]
        for i in range(0, len(missing), self.batch_size):
            self._encode(missing[i : i + self.batch_size])
        scores = [(pid, self.score(pid, query_terms)) for pid in pids]
        return sorted(scores, key=lambda x: x[1], reverse=True)[: self.final_k]

    def run(self) -> int:
        n = 0
        for qid, pids in self.top_k:
            self.run_file.writelines(qid, self.rerank(qid, pids))
            n += 1
            if n % 50 == 0:
                logger.info(f"reranked {n}/{len(self.top_k)} queries")
        return n


class CrossEncoderReRanker:
    """Rerank a top-k file with the cross-encoder model (reference
    evaluation/cross_encoder_reranker.py:12-62)."""

    def __init__(
        self,
        model,  # models.DeepImpactCrossEncoder
        top_k_path: Union[str, Path],
        collection_path: Union[str, Path],
        output_path: Union[str, Path],
        batch_size: int = 32,
    ):
        self.model = model
        self.top_k = TopKDataset(top_k_path)
        self.collection = Collection(collection_path)
        self.run_file = RunFile(output_path)
        self.batch_size = batch_size

    def rerank(self, qid: str) -> List[Tuple[str, float]]:
        query = self.top_k.queries[qid]
        pids = self.top_k[qid]
        scores: List[float] = []
        for i in range(0, len(pids), self.batch_size):
            batch = [self.collection[p] for p in pids[i : i + self.batch_size]]
            encs = self.model.process_cross_encoder_documents_and_query(batch, query)
            scores.extend(self.model.score_batch(encs).tolist())
        return sorted(zip(pids, scores), key=lambda x: x[1], reverse=True)

    def run(self) -> int:
        n = 0
        for qid in self.top_k.keys():
            self.run_file.writelines(qid, self.rerank(qid))
            n += 1
        return n
