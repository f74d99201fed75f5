"""Batch ranking of queries over an inverted index -> run file.

Counterpart of ``improving_learned_index_tpu/evaluation/ranker.py``
(capability parity with the reference Ranker, src/deep_impact/evaluation/
ranker.py:19-57 + rank.py): optionally restrict to qrels queries, process
query terms with the tokenizer, score them in batches on the card, and
write a 4-column run file.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from ..core.logging import get_logger
from ..data.datasets import Queries, QueryRelevanceDataset, RunFile
from ..search.select import build_engine
from ..utils.text_utils import expand_pairwise_terms

logger = get_logger("ranker")


class Ranker:
    def __init__(
        self,
        index_path: Union[str, Path],
        queries_path: Union[str, Path],
        output_path: Union[str, Path],
        tokenizer=None,
        qrels_path: Optional[Union[str, Path]] = None,
        dataset_type: str = "msmarco",
        pairwise: bool = False,
        engine: str = "auto",  # auto | hybrid
        batch_size: int = 256,
        top_k: int = 1000,
        dense_budget_bytes: int = 4 << 30,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.queries = Queries(queries_path, dataset_type=dataset_type)
        self.query_ids = list(self.queries.keys())
        if qrels_path is not None:
            qrels = QueryRelevanceDataset(qrels_path)
            self.query_ids = [q for q in qrels.keys()]
        self.tokenizer = tokenizer
        self.pairwise = pairwise
        self.batch_size = batch_size
        self.top_k = top_k
        self.engine = build_engine(
            index_path,
            engine=engine,
            dense_budget_bytes=dense_budget_bytes,
            device=device,
        )
        self.run_file = RunFile(output_path)

    def get_query_terms(self, qid: str):
        terms = self.tokenizer.process_query(self.queries[qid])
        if self.pairwise:
            expand_pairwise_terms(terms)
        return terms

    def run(self) -> int:
        total = 0
        for i in range(0, len(self.query_ids), self.batch_size):
            qids = self.query_ids[i : i + self.batch_size]
            term_sets = [self.get_query_terms(qid) for qid in qids]
            results = self.engine.score_batch(term_sets, self.top_k)
            for qid, scores in zip(qids, results):
                self.run_file.writelines(qid, scores)
                total += 1
            logger.info(f"ranked {total}/{len(self.query_ids)} queries")
        return total
