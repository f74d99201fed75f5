"""CLI: build the binary inverted index from a quantized text forward index
(reference: python -m src.deep_impact.inverted_index.create, create.py:58-68).
The impact-store input of the JAX CLI is not ported yet."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index.inverted import InvertedIndexData


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--deep_impact_collection_path", type=Path, required=True)
    parser.add_argument("-o", "--output_path", type=Path, required=True)
    args = parser.parse_args(argv)
    if args.deep_impact_collection_path.is_dir():
        raise NotImplementedError("impact-store input (a directory) is not ported yet")
    index = InvertedIndexData.from_forward_index(args.deep_impact_collection_path)
    index.save(args.output_path)
    print(
        f"inverted index: {len(index)} terms, {index.num_postings} postings "
        f"-> {args.output_path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
