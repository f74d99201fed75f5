"""CLI: BM25 baseline ranking, on the host (replaces the reference's
PyTerrier harness, src/llama2/evaluation/evaluate.py).

    python -m improving_learned_index_tpu_torch.cli.bm25 \\
        --collection_path collection.tsv --queries_path queries.tsv \\
        --output_path run.tsv --vocab_path vocab.txt

Terms come from the built-in tokenizer's segmenter; scoring is numpy
(``evaluation.bm25``), so ``--device`` is accepted and not used.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..data.datasets import Queries, RunFile, stream_collection
from ..evaluation.bm25 import BM25Index
from .common import add_model_args, build_tokenizer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(parser)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--collection_type", choices=["msmarco", "beir"], default="msmarco")
    parser.add_argument("--queries_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--k1", type=float, default=1.2)
    parser.add_argument("--b", type=float, default=0.75)
    parser.add_argument("--top_k", type=int, default=1000)
    args = parser.parse_args(argv)
    tokenizer = build_tokenizer(args)
    index = BM25Index(k1=args.k1, b=args.b).build(
        stream_collection(args.collection_path, args.collection_type), tokenizer
    )
    queries = Queries(args.queries_path)
    run = RunFile(args.output_path)
    for qid, query in queries:
        run.writelines(qid, index.score(tokenizer.process_query(query), args.top_k))
    print(f"ranked {len(queries)} queries -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
