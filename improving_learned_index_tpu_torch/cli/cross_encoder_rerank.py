"""CLI: cross-encoder rerank of a top-k file
(reference: python -m src.deep_impact.cross_encoder_rerank).

    python -m improving_learned_index_tpu_torch.cli.cross_encoder_rerank \\
        --top_k_path top_k.tsv --collection_path collection.tsv \\
        --output_path reranked.tsv --vocab_path vocab.txt \\
        --checkpoint ckpt/DeepImpactCrossEncoder_final.pt --max_length 256 \\
        [--batch_size 32] [--device cpu]

The flags are the JAX package's plus ``--device``; the model is always
``DeepImpactCrossEncoder``.  The top-k file holds ``qid\\tpid\\tquery\\tpassage``
lines; each candidate's passage is read from the collection and scored
from the [CLS] state of "{passage} [SEP] {query}" on the card (the
``short_attention`` kernel at S in {128, 256}), in batches of
``--batch_size`` a query.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..evaluation.reranker import CrossEncoderReRanker
from .common import add_model_args, build_model


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(parser)
    parser.add_argument("--top_k_path", type=Path, required=True)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--batch_size", type=int, default=32)
    args = parser.parse_args(argv)
    args.model_kind = "cross_encoder"
    rr = CrossEncoderReRanker(
        build_model(args),
        args.top_k_path,
        args.collection_path,
        args.output_path,
        batch_size=args.batch_size,
    )
    print(f"reranked {rr.run()} queries -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
