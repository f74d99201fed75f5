"""Anserini JsonVectorCollection export for interop.

Counterpart of ``improving_learned_index_tpu/index/anserini.py`` (reference
src/deep_impact/indexing/convert_to_anserini.py:9-24; README route Anserini
-> CIFF -> PISA): the same JSONL from a text forward index or a binary
impact store, host Python only.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

from .forward_index import parse_line

PathLike = Union[str, Path]


def convert_to_anserini(input_file_path: PathLike, output_file_path: PathLike) -> int:
    """Forward index lines (or a binary impact store directory) -> JSONL
    {"id", "contents": "", "vector": {...}}."""
    from .impact_store import ImpactStore, is_impact_store

    n = 0
    with open(output_file_path, "w", encoding="utf-8") as out:
        if is_impact_store(input_file_path):
            for doc_id, impacts in ImpactStore(input_file_path).iter_docs():
                vector = {t: float(v) for t, v in impacts.items()}
                json.dump({"id": doc_id, "contents": "", "vector": vector}, out)
                out.write("\n")
                n += 1
            return n
        with open(input_file_path, encoding="utf-8") as f:
            for doc_id, line in enumerate(f):
                vector = {t: float(v) for t, v in parse_line(line).items()}
                json.dump({"id": doc_id, "contents": "", "vector": vector}, out)
                out.write("\n")
                n += 1
    return n
