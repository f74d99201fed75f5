"""CLI: expand a collection from PRECOMPUTED query/term stores.

Two reference entry points collapse into one command:

- ``--style doc2query_mm`` — doc2query-- score-filtered expansion
  (reference ``python -m src.doc2query--``, __main__.py:17-40): per-doc
  (query, score) lists filtered by a global score percentile, appended as
  unique novel terms (default) or full queries.
- ``--style tilde`` — TILDE term lists, non-duplicate terms appended
  (reference src/tilde_expansions/create_expanded_collection.py:36-41).

The reference streams the stores from HF hub repos; nothing is downloaded
here, so both styles read a local JSONL (``{"doc_id", "queries": [...]}``
with optional scores — see expand.precomputed.load_scored_queries_jsonl).
Host only: it takes ``cli.common``'s model flags, as the JAX CLI does, and
builds only the tokenizer.

    python -m improving_learned_index_tpu_torch.cli.expand_precomputed --vocab_path vocab.txt \
        --collection_path c.tsv --queries_path store.jsonl --output_path expanded.tsv \
        [--style doc2query_mm|tilde] [--threshold 70] [--append terms|queries]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..expand.precomputed import (
    expand_with_precomputed,
    load_scored_queries_jsonl,
    tilde_expand,
)
from .common import add_model_args, build_tokenizer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(parser)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--collection_type", choices=["msmarco", "beir"], default="msmarco")
    parser.add_argument("--queries_path", type=Path, required=True,
                        help="JSONL store of precomputed queries/terms per doc")
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--style", choices=["doc2query_mm", "tilde"],
                        default="doc2query_mm")
    parser.add_argument("--threshold", type=float, default=70.0,
                        help="global score percentile cutoff (0-1 taken as a "
                             "fraction, like the reference __main__.py:28-30)")
    parser.add_argument("--append", choices=["terms", "queries"], default="terms",
                        help="'terms' = unique novel terms only (the reference's "
                             "--unique_terms_only); 'queries' = full query text")
    args = parser.parse_args(argv)

    threshold = args.threshold
    if 0 <= threshold <= 1:
        threshold *= 100
    elif not 0 <= threshold <= 100:
        raise SystemExit("--threshold must be in [0, 100] (or [0, 1] as a fraction)")

    tokenizer = build_tokenizer(args)
    store = load_scored_queries_jsonl(args.queries_path)
    if args.style == "tilde":
        terms = {doc_id: [q for q, _ in qs] for doc_id, qs in store.items()}
        n = tilde_expand(
            args.collection_path, terms, args.output_path, tokenizer,
            args.collection_type,
        )
    else:
        n = expand_with_precomputed(
            args.collection_path, store, args.output_path, tokenizer,
            percentile=threshold, append=args.append,
            collection_type=args.collection_type,
        )
    print(f"expanded {n} documents -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
