"""Hard-negative training triples from a mined-negatives JSONL
(reference scripts/construct_hard_neg_dataset.py:12-34): each line
``{"qid", "pos": [...], "neg": {system: [...]}}``; negatives are unioned
across mining systems, every (pos, neg) pair becomes a triple, shuffled.

The port's copy of
``improving_learned_index_tpu/scripts/construct_hard_neg_dataset.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.construct_hard_neg_dataset``.
"""

from __future__ import annotations

import argparse
import gzip
import json
import random
from pathlib import Path
from typing import Union


def construct(negatives_path: Union[str, Path], output_path: Union[str, Path], seed: int = 0) -> int:
    opener = gzip.open if str(negatives_path).endswith(".gz") else open
    triples = []
    with opener(negatives_path, "rt", encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            data = json.loads(line)
            qid = data["qid"]
            negs = set()
            for neg_ids in data["neg"].values():
                negs.update(neg_ids)
            triples.extend((qid, pid, nid) for pid in data["pos"] for nid in negs)
    random.Random(seed).shuffle(triples)
    with open(output_path, "w", encoding="utf-8") as f:
        for qid, pid, nid in triples:
            f.write(f"{qid}\t{pid}\t{nid}\n")
    return len(triples)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--negatives_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    n = construct(args.negatives_path, args.output_path, args.seed)
    print(f"wrote {n} triples -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
