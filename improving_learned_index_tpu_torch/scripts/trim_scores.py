"""Filter a gzip-pickled teacher-score map to pids present in a collection
(reference scripts/trim_scores.py:69-110).

The port's copy of
``improving_learned_index_tpu/scripts/trim_scores.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.trim_scores``.
"""

from __future__ import annotations

import argparse
import gzip
import pickle
from pathlib import Path
from typing import Set, Union

from ..data.datasets import stream_collection


def trim(
    scores_path: Union[str, Path],
    collection_path: Union[str, Path],
    output_path: Union[str, Path],
    collection_type: str = "msmarco",
) -> int:
    valid_pids: Set[str] = {
        pid for pid, _ in stream_collection(collection_path, collection_type)
    }
    with gzip.open(scores_path, "rb") as f:
        scores = pickle.load(f)
    trimmed = {}
    kept = 0
    for qid, pid_scores in scores.items():
        new_map = {pid: s for pid, s in pid_scores.items() if str(pid) in valid_pids}
        if new_map:
            trimmed[qid] = new_map
            kept += len(new_map)
    with gzip.open(output_path, "wb") as f:
        pickle.dump(trimmed, f)
    return kept


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--scores_path", type=Path, required=True)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--collection_type", default="msmarco")
    args = parser.parse_args(argv)
    n = trim(args.scores_path, args.collection_path, args.output_path, args.collection_type)
    print(f"kept {n} pid-score entries -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
