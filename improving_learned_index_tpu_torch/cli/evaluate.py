"""CLI: MRR/Recall over a run file vs qrels
(reference: python -m src.deep_impact.evaluate, evaluate.py:6-18).  Host
code.

    python -m improving_learned_index_tpu_torch.cli.evaluate \\
        --run_file_path run.tsv --qrels_path qrels.tsv
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..evaluation.run_metrics import MRR_DEPTHS, RECALL_DEPTHS, Metrics


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--run_file_path", type=Path, required=True)
    parser.add_argument("--qrels_path", type=Path, required=True)
    parser.add_argument("--mrr_depths", type=int, nargs="+", default=MRR_DEPTHS)
    parser.add_argument("--recall_depths", type=int, nargs="+", default=RECALL_DEPTHS)
    args = parser.parse_args(argv)
    metrics = Metrics(
        args.run_file_path, args.qrels_path, args.mrr_depths, args.recall_depths
    ).evaluate()
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
