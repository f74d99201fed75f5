"""CLI: merge expansions into the collection
(reference: python -m src.llama2.merge, merge.py:54-65).

    python -m improving_learned_index_tpu_torch.cli.merge --collection_path c.tsv \
        --queries_path expansions.jsonl --output_path merged.tsv --vocab_path vocab.txt
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..expand.merge import merge_collection_and_expansions
from .common import add_model_args, build_tokenizer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_model_args(parser)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--collection_type", choices=["msmarco", "beir"], default="msmarco")
    parser.add_argument("--queries_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    args = parser.parse_args(argv)
    n = merge_collection_and_expansions(
        args.collection_path,
        args.queries_path,
        args.output_path,
        build_tokenizer(args),
        args.collection_type,
    )
    print(f"merged {n} documents -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
