"""CLI: build a WordPiece vocabulary from a collection (the hermetic,
zero-network tokenizer stack; the reference always downloads HF
tokenizers)."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.datasets import stream_collection
from ..text import WordPieceVocab


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--collection_type", choices=["msmarco", "beir"], default="msmarco")
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--max_size", type=int, default=30522)
    parser.add_argument("--min_freq", type=int, default=2)
    args = parser.parse_args(argv)
    texts = (t for _, t in stream_collection(args.collection_path, args.collection_type))
    vocab = WordPieceVocab.build(texts, max_size=args.max_size, min_freq=args.min_freq)
    vocab.save(args.output_path)
    print(f"vocab of {len(vocab)} tokens -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
