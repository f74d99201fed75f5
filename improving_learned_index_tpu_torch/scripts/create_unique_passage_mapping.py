"""Deduplicate passages by id
(reference scripts/create_unique_passage_mapping.py:39-57): first occurrence
of each pid wins; writes the deduped collection and reports duplicates.

The port's copy of
``improving_learned_index_tpu/scripts/create_unique_passage_mapping.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.create_unique_passage_mapping``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Tuple, Union

from ..data.datasets import CollectionParser


def dedup(
    collection_path: Union[str, Path],
    output_path: Union[str, Path],
    collection_type: str = "msmarco",
) -> Tuple[int, int]:
    seen = set()
    kept = dropped = 0
    with open(collection_path, encoding="utf-8") as f, open(
        output_path, "w", encoding="utf-8"
    ) as out:
        for line in f:
            if not line.strip():
                continue
            pid, _ = CollectionParser.parse(line, collection_type)
            if pid in seen:
                dropped += 1
                continue
            seen.add(pid)
            out.write(line if line.endswith("\n") else line + "\n")
            kept += 1
    return kept, dropped


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--collection_type", default="msmarco")
    args = parser.parse_args(argv)
    kept, dropped = dedup(args.collection_path, args.output_path, args.collection_type)
    print(f"kept {kept}, dropped {dropped} duplicates -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
