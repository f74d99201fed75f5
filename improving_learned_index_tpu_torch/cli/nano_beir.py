"""CLI: NanoBEIR evaluation on the card
(reference: PYTHONPATH=src python src/deep_impact/evaluation/nano_beir_evaluator.py,
nano_beir_evaluator.py:236-243).

    python -m improving_learned_index_tpu_torch.cli.nano_beir \\
        --local_data_dir beir --vocab_path vocab.txt --checkpoint model.pt \\
        --max_length 256 --batch_size 512 [--device cpu]

``--local_data_dir`` holds BEIR-format directories
``<dataset>/{corpus.jsonl,queries.jsonl,qrels.tsv}``; without ``--datasets``
every such directory is evaluated.  The encode takes the card's attention
kernel at ``--max_length`` 128 or 256 (the default, 512, runs plain
attention).  Prints the metrics JSON: per dataset and ``avg``, each the
4-tuple (NDCG, MAP, Recall, P) @ {10, 100, 1000}.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..evaluation.nano_beir import DATASET_NAME_TO_ID, NanoBEIREvaluator
from .common import add_model_args, build_model


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(parser)
    parser.add_argument("--datasets", nargs="+", default=None,
                        choices=sorted(DATASET_NAME_TO_ID), help="default: all 13")
    parser.add_argument("--local_data_dir", type=Path, default=None)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--output", type=Path, default=None)
    args = parser.parse_args(argv)
    model = build_model(args)
    evaluator = NanoBEIREvaluator(
        batch_size=args.batch_size,
        verbose=True,
        local_data_dir=args.local_data_dir,
        datasets=args.datasets,
    )
    metrics = evaluator.evaluate_all(model)
    text = json.dumps(metrics, indent=2, default=str)
    print(text)
    if args.output:
        args.output.write_text(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
