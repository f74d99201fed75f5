"""Query / qrels / run-file I/O for the query path.

The port's copy of the query-path classes of
``improving_learned_index_tpu/data/datasets.py``, format-compatible with the
reference's data layer (src/utils/datasets.py): TSV or BEIR-JSONL queries,
qrels ``qid\\t0\\tpid\\t1`` and 4-column run files.  All ids are strings.
Collections, triples and distillation scores come with the training slice.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Sequence, Set, Tuple, Union

PathLike = Union[str, Path]


class QueryParser:
    @staticmethod
    def parse(line: str, collection_type: str = "msmarco") -> Tuple[str, str]:
        if collection_type == "msmarco":
            qid, query = line.rstrip("\n").split("\t", 1)
            return str(qid), query
        if collection_type == "beir":
            item = json.loads(line)
            return str(item["_id"]), item["text"]
        raise ValueError(f"unknown collection type {collection_type}")


class Queries:
    def __init__(self, queries_path: PathLike, dataset_type: str = "msmarco"):
        self.queries: Dict[str, str] = {}
        with open(queries_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                qid, query = QueryParser.parse(line, dataset_type)
                self.queries[qid] = query

    def __len__(self):
        return len(self.queries)

    def __getitem__(self, qid):
        return self.queries[str(qid)]

    def __iter__(self):
        return iter(self.queries.items())

    def keys(self):
        return self.queries.keys()


class QueryRelevanceDataset:
    """qrels: qid -> set(pid) in the (qid, 0, pid, 1) format
    (reference datasets.py:138-178)."""

    def __init__(self, qrels_path: PathLike):
        self.qrels: Dict[str, Set[str]] = {}
        with open(qrels_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                parts = line.rstrip("\n").split("\t")
                qid, x, pid, y = parts[0], int(parts[1]), parts[2], int(parts[3])
                if x != 0 or y != 1:
                    raise ValueError("Qrels file is not in the expected format")
                self.qrels.setdefault(str(qid), set()).add(str(pid))

    def __len__(self):
        return len(self.qrels)

    def __getitem__(self, qid) -> Set[str]:
        return self.qrels[str(qid)]

    def keys(self):
        return self.qrels.keys()


class RunFile:
    """4-column run file: qid \\t pid \\t rank \\t score (reference datasets.py:305-324)."""

    def __init__(self, run_file_path: PathLike):
        self.run_file_path = Path(run_file_path)

    def write(self, qid, pid, rank, score):
        with open(self.run_file_path, "a", encoding="utf-8") as f:
            f.write(f"{qid}\t{pid}\t{rank}\t{score}\n")

    def writelines(self, qid, scores: Sequence[Tuple[str, float]]):
        with open(self.run_file_path, "a", encoding="utf-8") as f:
            for rank, (pid, score) in enumerate(scores, start=1):
                f.write(f"{qid}\t{pid}\t{rank}\t{score}\n")

    def read(self) -> Iterator[Tuple[str, str, int, float]]:
        with open(self.run_file_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                qid, pid, rank, score = line.rstrip("\n").split("\t")
                yield str(qid), str(pid), int(rank), float(score)
