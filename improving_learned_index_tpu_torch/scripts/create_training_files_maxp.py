"""Per-passage variant of create_training_files (reference
scripts/create_training_files_maxp.py): documents are passages with
``doc_id#i`` ids; expansions keyed by parent ``doc_id`` apply to every one of
its passages.

The port's copy of
``improving_learned_index_tpu/scripts/create_training_files_maxp.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.create_training_files_maxp``.
"""

from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path
from typing import Union

from .create_training_files import expand_training_files


def expand_maxp(
    passage_mapping_path: Union[str, Path],
    expansions_path: Union[str, Path],
    output_docs_tsv: Union[str, Path],
    output_expansion_csv: Union[str, Path],
    max_length: int = 512,
    max_expansion_terms: int = 100,
) -> int:
    """Re-key doc-level expansions to each ``doc_id#i`` passage, then run the
    standard expansion."""
    passage_ids = []
    with open(passage_mapping_path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                passage_ids.append(line.rstrip("\n").split("\t", 1)[0])

    by_doc = {}
    with open(expansions_path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                e = json.loads(line)
                by_doc[str(e["doc_id"])] = e.get("queries", [])

    with tempfile.NamedTemporaryFile(
        "w", suffix=".jsonl", delete=False, encoding="utf-8"
    ) as tmp:
        for pid in passage_ids:
            doc_id = pid.split("#")[0]
            if doc_id in by_doc:
                tmp.write(json.dumps({"doc_id": pid, "queries": by_doc[doc_id]}) + "\n")
        tmp_path = tmp.name

    return expand_training_files(
        passage_mapping_path,
        tmp_path,
        output_docs_tsv,
        output_expansion_csv,
        max_length=max_length,
        max_expansion_terms=max_expansion_terms,
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--passage_mapping", type=Path, required=True,
                        help="TSV: doc_id#i \\t passage_text")
    parser.add_argument("--expansions_path", type=Path, required=True)
    parser.add_argument("--output_docs_tsv", type=Path, required=True)
    parser.add_argument("--output_expansion_csv", type=Path, required=True)
    parser.add_argument("--max_length", type=int, default=512)
    parser.add_argument("--max_expansion_terms", type=int, default=100)
    args = parser.parse_args(argv)
    n = expand_maxp(
        args.passage_mapping, args.expansions_path,
        args.output_docs_tsv, args.output_expansion_csv,
        args.max_length, args.max_expansion_terms,
    )
    print(f"expanded {n} passages -> {args.output_docs_tsv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
