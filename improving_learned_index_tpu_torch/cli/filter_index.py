"""CLI: delete documents from an inverted index without a corpus rebuild
(dedup, takedowns — no reference equivalent; create.py can only rebuild).

    python -m improving_learned_index_tpu_torch.cli.filter_index \
        -i inverted/ -o inverted_filtered/ --delete_ids_path removed.txt \
        --num_docs 1000000

``removed.txt``: one doc id per line.  Surviving documents renumber
compactly (the output equals a one-shot build over the kept corpus)."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index.inverted import InvertedIndexData


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--index_path", type=Path, required=True)
    parser.add_argument("-o", "--output_path", type=Path, required=True)
    parser.add_argument("--delete_ids_path", type=Path, required=True)
    parser.add_argument(
        "--num_docs", type=int, default=0,
        help="documents in the index (defaults to max doc id + 1 — pass "
        "explicitly if the corpus ends with posting-less documents)",
    )
    args = parser.parse_args(argv)
    with open(args.delete_ids_path) as f:
        ids = [int(line) for line in f if line.strip()]
    index = InvertedIndexData.load(args.index_path, num_docs=args.num_docs)
    out = index.delete_docs(ids)
    out.save(args.output_path)
    print(
        f"deleted {len(ids)} docs: {out.num_docs} docs, {len(out)} terms, "
        f"{out.num_postings} postings -> {args.output_path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
