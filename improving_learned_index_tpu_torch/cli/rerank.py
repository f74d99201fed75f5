"""CLI: impact-score rerank of a top-k run file
(reference: python -m src.deep_impact.rerank, rerank.py).

    python -m improving_learned_index_tpu_torch.cli.rerank \\
        --top_k_run_file_path run.tsv --queries_path queries.tsv \\
        --collection_path collection.tsv --output_path reranked.tsv \\
        --vocab_path vocab.txt --checkpoint ckpt/DeepImpact_final.pt \\
        --max_length 256 [--batch_size 128] [--device cpu]

The flags are the JAX package's plus ``--device``.  Each query's
candidates (the first 2,000 by rank) are encoded on the card (the
``short_attention`` kernel at S in {128, 256}) and cached across queries;
a candidate scores the sum of its impacts of the query's terms, and the
first 1,000 of a stable descending sort are written.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..evaluation.reranker import ReRanker
from .common import add_model_args, build_model


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(parser)
    parser.add_argument("--top_k_run_file_path", type=Path, required=True)
    parser.add_argument("--queries_path", type=Path, required=True)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--batch_size", type=int, default=128)
    args = parser.parse_args(argv)
    rr = ReRanker(
        build_model(args),
        args.top_k_run_file_path,
        args.queries_path,
        args.collection_path,
        args.output_path,
        batch_size=args.batch_size,
    )
    print(f"reranked {rr.run()} queries -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
