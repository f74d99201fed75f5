"""Build test queries + qrels by joining text->id mappings
(reference scripts/create_test_files.py:40-109, the VIFC fact-checking test
pipeline): a query-mapping CSV gives (query_id, query); a claim/evidence CSV
links query text to relevant document texts; a doc-mapping CSV gives
(doc_id, doc text).  Outputs queries.tsv and qrels ``qid 0 doc_id 1``.

The port's copy of
``improving_learned_index_tpu/scripts/create_test_files.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.create_test_files``.
"""

from __future__ import annotations

import argparse
import csv
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple, Union


def _sanitize(text: str) -> str:
    return text.replace("\t", " ").replace("\n", " ").replace("\r", " ").strip()


def create_test_files(
    query_mapping_path: Union[str, Path],
    pairs_path: Union[str, Path],
    doc_mapping_path: Union[str, Path],
    output_queries: Union[str, Path],
    output_qrels: Union[str, Path],
) -> Tuple[int, int, int]:
    """Returns (queries written, qrels written, missing docs)."""
    doc_text_to_id: Dict[str, str] = {}
    with open(doc_mapping_path, encoding="utf-8") as f:
        for row in csv.DictReader(f):
            doc_text_to_id[row["document"].strip()] = row["doc_id"].strip()

    query_to_docs: Dict[str, List[str]] = defaultdict(list)
    with open(pairs_path, encoding="utf-8") as f:
        for row in csv.DictReader(f):
            query_to_docs[row["query"].strip()].append(row["document"].strip())

    n_q = n_rel = missing = 0
    with open(query_mapping_path, encoding="utf-8") as f_in, open(
        output_queries, "w", encoding="utf-8"
    ) as f_q, open(output_qrels, "w", encoding="utf-8") as f_rel:
        for row in csv.DictReader(f_in):
            if "query_id" not in row or "query" not in row:
                continue
            qid = row["query_id"].strip()
            query_text = row["query"].strip()
            f_q.write(f"{qid}\t{_sanitize(query_text)}\n")
            n_q += 1
            for doc_text in query_to_docs.get(query_text, []):
                doc_id = doc_text_to_id.get(doc_text)
                if doc_id:
                    f_rel.write(f"{qid}\t0\t{doc_id}\t1\n")
                    n_rel += 1
                else:
                    missing += 1
    return n_q, n_rel, missing


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--query_mapping", type=Path, required=True)
    parser.add_argument("--pairs_file", type=Path, required=True,
                        help="CSV with columns query,document (relevance pairs)")
    parser.add_argument("--doc_mapping", type=Path, required=True,
                        help="CSV with columns doc_id,document")
    parser.add_argument("--output_queries", type=Path, required=True)
    parser.add_argument("--output_qrels", type=Path, required=True)
    args = parser.parse_args(argv)
    n_q, n_rel, missing = create_test_files(
        args.query_mapping, args.pairs_file, args.doc_mapping,
        args.output_queries, args.output_qrels,
    )
    print(f"{n_q} queries, {n_rel} qrels ({missing} docs unmapped)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
