"""CLI: merge inverted indexes built over disjoint corpus shards into one
(incremental indexing — no reference equivalent: the reference's
inverted_index/create.py can only rebuild from the full corpus).

    python -m improving_learned_index_tpu_torch.cli.merge_indexes \
        -i inverted_shard0/ inverted_shard1/ -o inverted/ \
        --num_docs 500000 500000

Doc ids of shard i are offset by the total documents of shards 0..i-1, so
shards are consecutive corpus slices; the merged index is byte-identical to
a one-shot build over the concatenated corpus."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index.inverted import InvertedIndexData


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--index_paths", type=Path, nargs="+", required=True)
    parser.add_argument("-o", "--output_path", type=Path, required=True)
    parser.add_argument(
        "--num_docs", type=int, nargs="+", default=None,
        help="documents per shard (defaults to each shard's max doc id + 1 — "
        "pass explicitly if shards end with posting-less documents)",
    )
    args = parser.parse_args(argv)
    if args.num_docs is not None and len(args.num_docs) != len(args.index_paths):
        parser.error("--num_docs must list one count per index")
    indexes = [
        InvertedIndexData.load(p, num_docs=args.num_docs[i] if args.num_docs else 0)
        for i, p in enumerate(args.index_paths)
    ]
    merged = InvertedIndexData.merge(indexes)
    merged.save(args.output_path)
    print(
        f"merged {len(indexes)} indexes: {len(merged)} terms, "
        f"{merged.num_postings} postings, {merged.num_docs} docs -> {args.output_path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
