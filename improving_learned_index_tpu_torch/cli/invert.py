"""CLI: build the binary inverted index from a quantized forward index, a text
file or a binary impact store directory
(reference: python -m src.deep_impact.inverted_index.create, create.py:58-68)."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index.impact_store import is_impact_store
from ..index.inverted import InvertedIndexData


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--deep_impact_collection_path", type=Path, required=True)
    parser.add_argument("-o", "--output_path", type=Path, required=True)
    args = parser.parse_args(argv)
    if is_impact_store(args.deep_impact_collection_path):
        index = InvertedIndexData.from_impact_store(args.deep_impact_collection_path)
    else:
        index = InvertedIndexData.from_forward_index(args.deep_impact_collection_path)
    index.save(args.output_path)
    print(
        f"inverted index: {len(index)} terms, {index.num_postings} postings "
        f"-> {args.output_path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
