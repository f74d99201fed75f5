"""Merge generated queries into the collection (novel terms only).

Counterpart of ``improving_learned_index_tpu/expand/merge.py`` (the
reference merge CLI, src/llama2/merge.py:15-50): zip collection lines with
expansion JSONL (a prefix of the collection may be expanded), raise on a
doc-id mismatch, append only query terms not already in the document
(``utils.text_utils.merge_document_and_queries``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Union

from ..core.logging import get_logger
from ..data.datasets import CollectionParser
from ..utils.text_utils import merge_document_and_queries

logger = get_logger("merge")


def merge_collection_and_expansions(
    collection_path: Union[str, Path],
    queries_path: Union[str, Path],
    output_path: Union[str, Path],
    tokenizer,
    collection_type: str = "msmarco",
) -> int:
    n = 0
    with open(collection_path, encoding="utf-8") as f, open(
        queries_path, encoding="utf-8"
    ) as q, open(output_path, "w", encoding="utf-8") as out:
        for line, query_line in zip(f, q):
            doc_id, doc = CollectionParser.parse(line, collection_type)
            expansion = json.loads(query_line)
            if doc_id != str(expansion["doc_id"]):
                raise ValueError(f"Doc id mismatch: {doc_id} != {expansion['doc_id']}")
            merged = merge_document_and_queries(doc, expansion["queries"], tokenizer)
            out.write(f"{doc_id}\t{merged}\n")
            n += 1
    logger.info(f"merged {n} documents")
    return n
