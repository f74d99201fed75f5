"""qrels + queries + collection -> ``document \\t query`` pairs for doc2query
fine-tuning (reference src/llama2/prepare_dataset.py:11-21).

The port's copy of
``improving_learned_index_tpu/scripts/prepare_dataset.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.prepare_dataset``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Union

from ..data.datasets import Collection, Queries, QueryRelevanceDataset


def prepare(
    qrels_path: Union[str, Path],
    queries_path: Union[str, Path],
    collection_path: Union[str, Path],
    output_path: Union[str, Path],
) -> int:
    queries = Queries(queries_path)
    collection = Collection(collection_path)
    qrels = QueryRelevanceDataset(qrels_path)
    n = 0
    with open(output_path, "w", encoding="utf-8") as f:
        for qid in qrels.keys():
            query = queries[qid]
            for doc_id in qrels[qid]:
                f.write(f"{collection[doc_id]}\t{query}\n")
                n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--qrels_path", type=Path, required=True)
    parser.add_argument("--queries_path", type=Path, required=True)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    args = parser.parse_args(argv)
    n = prepare(args.qrels_path, args.queries_path, args.collection_path, args.output_path)
    print(f"wrote {n} document-query pairs -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
