"""CLI: rank queries over an inverted index into a run file
(reference: python -m src.deep_impact.rank, rank.py:6-22).

    python -m improving_learned_index_tpu_torch.cli.rank \\
        --index_path IDX --queries_path queries.tsv --output_path run.tsv \\
        --vocab_path vocab.txt [--qrels_path qrels.tsv] \\
        [--engine auto|device|hybrid|host|native] [--device cpu]

The card engines (auto, device, hybrid) run on ``cuda`` unless
``--device cpu``; host and native run on the host and take no device.  The
JAX CLI's TPU-only flags are left out: ``--use_pallas`` (the port's kernels
always run on the card and never elsewhere) and ``--tail_partitioned``
(not ported).  ``--approx_top_k`` is accepted and raises: the port's top-k
is exact.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..evaluation.ranker import Ranker
from ..search.select import ENGINES
from .common import add_tokenizer_args, build_tokenizer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_tokenizer_args(parser)
    parser.add_argument("--index_path", type=Path, required=True)
    parser.add_argument("--queries_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--qrels_path", type=Path, default=None)
    parser.add_argument("--dataset_type", choices=["msmarco", "beir"], default="msmarco")
    parser.add_argument("--pairwise", action="store_true")
    parser.add_argument("--engine", choices=list(ENGINES), default="auto",
                        help="auto (default) picks by corpus size: hybrid "
                        "from 4,000 docs, device below")
    parser.add_argument("--top_k", type=int, default=1000)
    parser.add_argument("--approx_top_k", action="store_true",
                        help="not ported: raises (the port's top-k is exact)")
    parser.add_argument("--dense_budget_gb", type=float, default=4.0,
                        help="hybrid engine: device memory for dense "
                        "heavy-term rows (bf16)")
    parser.add_argument("--device", default=None,
                        help="torch device of the card engines; default "
                        "cuda (cpu only when asked for)")
    args = parser.parse_args(argv)

    ranker = Ranker(
        index_path=args.index_path,
        queries_path=args.queries_path,
        output_path=args.output_path,
        tokenizer=build_tokenizer(args),
        qrels_path=args.qrels_path,
        dataset_type=args.dataset_type,
        pairwise=args.pairwise,
        engine=args.engine,
        top_k=args.top_k,
        approx_top_k=args.approx_top_k,
        dense_budget_bytes=int(args.dense_budget_gb * (1 << 30)),
        device=args.device,
    )
    n = ranker.run()
    print(f"ranked {n} queries -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
