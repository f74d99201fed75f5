"""MaxP sliding-window passaging CLI
(reference scripts/create_passages.py:9-23,109-127): window/stride word
chunks, per-window expansion append, integer pids + pid_mapping.txt.

The port's copy of
``improving_learned_index_tpu/scripts/create_passages.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.create_passages``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..data.datasets import stream_collection
from ..search.maxp import write_passage_files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--collection_type", default="msmarco")
    parser.add_argument("--output_collection", type=Path, required=True)
    parser.add_argument("--output_mapping", type=Path, required=True)
    parser.add_argument("--expansions_path", type=Path, default=None,
                        help="JSONL {doc_id, queries} appended to every window")
    parser.add_argument("--window", type=int, default=250)
    parser.add_argument("--stride", type=int, default=100)
    args = parser.parse_args(argv)

    expansion = None
    if args.expansions_path:
        expansion = {}
        with open(args.expansions_path, encoding="utf-8") as f:
            for line in f:
                if line.strip():
                    e = json.loads(line)
                    expansion[str(e["doc_id"])] = " ".join(e.get("queries", []))

    n = write_passage_files(
        stream_collection(args.collection_path, args.collection_type),
        args.output_collection,
        args.output_mapping,
        expansion_per_doc=expansion,
        window=args.window,
        stride=args.stride,
    )
    print(f"wrote {n} passages -> {args.output_collection}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
