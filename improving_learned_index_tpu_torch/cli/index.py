"""CLI: encode a collection into a forward index on the card
(reference: python -m src.deep_impact.index, src/deep_impact/index.py:47-68).

    python -m improving_learned_index_tpu_torch.cli.index \\
        --collection_path collection.tsv --output_file_path collection.index \\
        --vocab_path vocab.txt --max_length 256 [--pack] [--device cpu] \\
        [--store_path collection.store] [--resume]

``--store_path`` writes the binary impact store (index/impact_store.py)
beside or instead of the text forward index; ``cli.quantize`` and
``cli.invert`` take it as their input.

The short-attention kernel runs at ``--max_length`` 128 or 256; at the
default 512 (``--model_kind xlmr``'s length) and other multiples of 128 the
flash-attention kernel runs (``models/encoder.attention_route``), where the
JAX package runs its plain attention route off the TPU.
``--model_kind pairwise`` writes ``term1|term2`` composite postings too; its
pair head reads attention maps, so it runs the plain attention route at
every length, as the JAX package does.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..core.config import IndexConfig
from ..index.indexer import Indexer
from .common import add_model_args, build_model


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_model_args(parser)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--collection_type", choices=["msmarco", "beir"], default="msmarco")
    parser.add_argument("--output_file_path", type=Path, default=None,
                        help="reference-format text forward index")
    parser.add_argument("--store_path", type=Path, default=None,
                        help="binary impact store directory (array fast path "
                        "for the quantize/invert stages)")
    parser.add_argument("--model_batch_size", type=int, default=32)
    parser.add_argument("--max_terms", type=int, default=None)
    parser.add_argument("--resume", action="store_true",
                        help="continue a run killed mid-encode: outputs are "
                        "repaired to the last consistent document and "
                        "encoding restarts there")
    parser.add_argument("--pack", action="store_true",
                        help="sequence packing: several short documents per "
                        "row with block-diagonal attention (same scores); "
                        "--model_batch_size then counts packed rows")
    args = parser.parse_args(argv)
    if args.output_file_path is None and args.store_path is None:
        parser.error("need --output_file_path and/or --store_path")

    model = build_model(args)
    max_length = args.max_length or model.max_length
    config = IndexConfig(
        max_length=max_length,
        max_terms=args.max_terms or max_length,
        model_batch_size=args.model_batch_size,
        pack_sequences=args.pack,
    )
    n = Indexer(model, config).index_to_file(
        args.collection_path,
        args.output_file_path,
        args.collection_type,
        store_path=args.store_path,
        resume=args.resume,
    )
    dest = " + ".join(str(p) for p in (args.output_file_path, args.store_path) if p)
    print(f"indexed {n} documents -> {dest}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
