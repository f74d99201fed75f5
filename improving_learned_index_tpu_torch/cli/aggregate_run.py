"""CLI: MaxP aggregation of a passage run into a document run
(reference: python -m src.deep_impact.aggregate_run).  Host code.

    python -m improving_learned_index_tpu_torch.cli.aggregate_run \\
        --run_file run.tsv --mapping pid_mapping.txt --output doc_run.tsv
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..search.maxp import aggregate_run


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--run_file", type=Path, required=True)
    parser.add_argument("--mapping", type=Path, required=True)
    parser.add_argument("--output", type=Path, required=True)
    parser.add_argument("--top_k", type=int, default=1000)
    args = parser.parse_args(argv)
    n = aggregate_run(args.run_file, args.mapping, args.output, args.top_k)
    print(f"wrote {n} aggregated rows -> {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
