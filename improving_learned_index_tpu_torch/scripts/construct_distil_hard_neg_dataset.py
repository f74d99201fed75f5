"""Distillation triples with teacher scores
(reference scripts/construct_distil_hard_neg_dataset.py:13-35): qrels
positives paired with every teacher-scored negative, 5-column TSV
``qid pos neg pos_score neg_score``, shuffled.

The port's copy of
``improving_learned_index_tpu/scripts/construct_distil_hard_neg_dataset.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.construct_distil_hard_neg_dataset``.
"""

from __future__ import annotations

import argparse
import gzip
import pickle
import random
from pathlib import Path
from typing import Union

from ..data.datasets import QueryRelevanceDataset


def construct(
    qrels_path: Union[str, Path],
    scores_path: Union[str, Path],
    output_path: Union[str, Path],
    seed: int = 0,
) -> int:
    qrels = QueryRelevanceDataset(qrels_path)
    with gzip.open(scores_path, "rb") as f:
        scores = pickle.load(f)

    triples = []
    positive_scores = {}
    for qid in qrels.keys():
        if qid not in scores:
            continue
        positive_scores[qid] = {
            pid: scores[qid].pop(pid) for pid in qrels[qid] if pid in scores[qid]
        }
        triples.extend(
            (qid, pid, nid)
            for pid in positive_scores[qid]
            for nid in scores[qid].keys()
        )
    random.Random(seed).shuffle(triples)
    with open(output_path, "w", encoding="utf-8") as f:
        for qid, pid, nid in triples:
            f.write(
                f"{qid}\t{pid}\t{nid}\t{positive_scores[qid][pid]}\t{scores[qid][nid]}\n"
            )
    return len(triples)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--qrels_path", type=Path, required=True)
    parser.add_argument("--scores_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    n = construct(args.qrels_path, args.scores_path, args.output_path, args.seed)
    print(f"wrote {n} scored triples -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
