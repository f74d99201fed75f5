"""MS MARCO-style run-file metrics: MRR@k and Recall@k.

The port's copy of ``Metrics.evaluate`` from
``improving_learned_index_tpu/evaluation/run_metrics.py`` (semantics parity
with the reference Metrics class, src/deep_impact/evaluation/
metrics.py:13-74): MRR uses the best (lowest) rank of any relevant passage
per query; recall divides hits-at-depth by the query's total relevant
count; both average over *all* qrels queries (queries missing from the run
contribute 0); reported rounded to 3 decimals.  ``evaluate_recall_for_top_k``
is the recall of a top-k file at its full depth.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Sequence, Union

from ..core.logging import get_logger
from ..data.datasets import QueryRelevanceDataset, RunFile, TopKDataset

logger = get_logger("metrics")

MRR_DEPTHS = [10]
RECALL_DEPTHS = [3, 10, 20, 50] + list(range(100, 1001, 100))


class Metrics:
    def __init__(
        self,
        run_file_path: Union[str, Path],
        qrels_path: Union[str, Path],
        mrr_depths: Sequence[int] = tuple(MRR_DEPTHS),
        recall_depths: Sequence[int] = tuple(RECALL_DEPTHS),
    ):
        self.run_file = RunFile(run_file_path)
        self.qrels = QueryRelevanceDataset(qrels_path)
        self.mrr_depths = list(mrr_depths)
        self.recall_depths = list(recall_depths)

    def evaluate(self) -> Dict[str, float]:
        relevant_ranks: Dict[str, List[int]] = defaultdict(list)
        for qid, pid, rank, _ in self.run_file.read():
            if pid in self.qrels[qid]:
                relevant_ranks[qid].append(rank)

        mrr_sums = {d: 0.0 for d in self.mrr_depths}
        recall_sums = {d: 0.0 for d in self.recall_depths}
        for qid, ranks in relevant_ranks.items():
            ranks.sort()
            best = ranks[0]
            for d in mrr_sums:
                if best <= d:
                    mrr_sums[d] += 1.0 / best
            for d in recall_sums:
                hits = sum(1 for r in ranks if r <= d)
                recall_sums[d] += hits / len(self.qrels[qid])

        n = len(self.qrels)
        out: Dict[str, float] = {}
        for d in sorted(mrr_sums):
            out[f"MRR@{d}"] = round(mrr_sums[d] / n, 3)
            logger.info(f"MRR@{d} = {out[f'MRR@{d}']}")
        for d in sorted(recall_sums):
            out[f"Recall@{d}"] = round(recall_sums[d] / n, 3)
            logger.info(f"Recall@{d} = {out[f'Recall@{d}']}")
        return out

    @staticmethod
    def evaluate_recall_for_top_k(qrels: QueryRelevanceDataset, top_k: TopKDataset) -> float:
        """Recall at max depth over a top-k file (reference metrics.py:59-74)."""
        if not set(top_k.queries.keys()).issubset(set(qrels.keys())):
            raise AssertionError("TopK file contains queries not in the Qrels file")
        vals = [
            len(qrels[qid].intersection(set(top_k[qid]))) / len(qrels[qid])
            for qid in top_k.keys()
        ]
        recall = round(sum(vals) / len(vals), 3)
        logger.info(f"Recall@{top_k.max_len} = {recall}")
        return recall
