"""Expand raw documents with the top-K most frequent *novel* query terms
under a shared token budget (reference scripts/create_training_files.py:
Counter-based frequency ranking 87-107, dedup against document terms
150-161, [doc]+[expansion] <= max_length truncation 176-207).

Inputs:
- raw docs TSV: ``doc_id \\t text``
- expansions JSONL: ``{"doc_id", "queries": [str, ...]}`` (the output of
  expand.generate) — each query's whitespace terms are counted.

Outputs: expanded docs TSV, expansion-terms CSV (doc_id, added_terms), and
optionally a queries TSV passthrough.

The port's copy of
``improving_learned_index_tpu/scripts/create_training_files.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.create_training_files``.
"""

from __future__ import annotations

import argparse
import json
import re
from collections import Counter, defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Union


def sanitize(text: str) -> str:
    return re.sub(r"[\t\n\r]+", " ", text).strip()


def expand_training_files(
    doc_mapping_path: Union[str, Path],
    expansions_path: Union[str, Path],
    output_docs_tsv: Union[str, Path],
    output_expansion_csv: Union[str, Path],
    tokenize: Optional[Callable[[str], List[str]]] = None,
    max_length: int = 512,
    max_expansion_terms: int = 100,
) -> int:
    """Returns the number of expanded documents written."""
    if tokenize is None:
        tokenize = str.split  # whitespace token budget by default

    raw_docs: Dict[str, str] = {}
    with open(doc_mapping_path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                doc_id, text = line.rstrip("\n").split("\t", 1)
                raw_docs[str(doc_id)] = text

    doc_expansions: Dict[str, Counter] = defaultdict(Counter)
    with open(expansions_path, encoding="utf-8") as f:
        for line in f:
            if not line.strip():
                continue
            entry = json.loads(line)
            doc_id = str(entry.get("doc_id", "")).strip()
            if not doc_id:
                continue
            for q in entry.get("queries", []):
                text = q if isinstance(q, str) else q.get("query_seg", "")
                if text:
                    doc_expansions[doc_id].update(text.split())

    n = 0
    with open(output_docs_tsv, "w", encoding="utf-8") as f_doc, open(
        output_expansion_csv, "w", encoding="utf-8"
    ) as f_exp:
        f_exp.write("doc_id,expansion_terms\n")
        for doc_id, term_counts in doc_expansions.items():
            raw = raw_docs.get(doc_id)
            if raw is None:
                continue
            existing = set(raw.split())
            selected: List[str] = []
            for term, _ in term_counts.most_common():
                if term not in existing:
                    selected.append(term)
                if len(selected) >= max_expansion_terms:
                    break
            expansion = sanitize(" ".join(t.replace("_", " ") for t in selected))
            f_exp.write(f'{doc_id},"{expansion}"\n')

            exp_tokens = tokenize(expansion)
            budget = max_length - len(exp_tokens)
            if budget <= 0:
                final = " ".join(exp_tokens[:max_length])
            else:
                doc_tokens = tokenize(raw)
                final = " ".join(doc_tokens[:budget] + exp_tokens)
            f_doc.write(f"{doc_id}\t{sanitize(final)}\n")
            n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--doc_mapping", type=Path, required=True)
    parser.add_argument("--expansions_path", type=Path, required=True)
    parser.add_argument("--output_docs_tsv", type=Path, required=True)
    parser.add_argument("--output_expansion_csv", type=Path, required=True)
    parser.add_argument("--max_length", type=int, default=512)
    parser.add_argument("--max_expansion_terms", type=int, default=100)
    args = parser.parse_args(argv)
    n = expand_training_files(
        args.doc_mapping,
        args.expansions_path,
        args.output_docs_tsv,
        args.output_expansion_csv,
        max_length=args.max_length,
        max_expansion_terms=args.max_expansion_terms,
    )
    print(f"expanded {n} documents -> {args.output_docs_tsv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
