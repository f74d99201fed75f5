"""Collection / query / qrels / run-file / training-data I/O.

The port's copy of ``improving_learned_index_tpu/data/datasets.py``,
format-compatible with the reference's data layer (src/utils/datasets.py):
TSV or BEIR-JSONL collections and queries, MS MARCO triples, qrels
``qid\\t0\\tpid\\t1``, top-k files ``qid\\tpid\\tquery\\tpassage``,
gzip-pickled distillation score maps and 4-column run files.  All ids are
strings.  A malformed top-k file raises ``AssertionError`` with the JAX
package's message (raised, not asserted, so ``-O`` keeps the check).
"""

from __future__ import annotations

import gzip
import json
import pickle
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple, Union

PathLike = Union[str, Path]


class CollectionParser:
    @staticmethod
    def parse(line: str, collection_type: str = "msmarco") -> Tuple[str, str]:
        if collection_type == "msmarco":
            pid, passage = line.rstrip("\n").split("\t", 1)
            return str(pid), passage
        if collection_type == "beir":
            item = json.loads(line)
            return str(item["_id"]), (item.get("title", "") + " " + item["text"]).strip()
        raise ValueError(f"unknown collection type {collection_type}")


def stream_collection(
    collection_path: PathLike, dataset_type: str = "msmarco"
) -> Iterator[Tuple[str, str]]:
    """Stream (pid, passage) without materializing the corpus -- the encode
    pipeline's input path (reference index.py:33-44)."""
    with open(collection_path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                yield CollectionParser.parse(line, dataset_type)


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


class Collection:
    def __init__(
        self,
        collection_path: PathLike,
        offset: Optional[int] = None,
        limit: Optional[int] = None,
        dataset_type: str = "msmarco",
    ):
        self.collection: Dict[str, str] = {}
        off = offset or 0
        lim = limit if limit is not None else float("inf")
        with open(collection_path, encoding="utf-8") as f:
            for idx, line in enumerate(f):
                if idx < off:
                    continue
                if idx >= off + lim:
                    break
                pid, passage = CollectionParser.parse(line, dataset_type)
                self.collection[pid] = passage

    def __len__(self):
        return len(self.collection)

    def __getitem__(self, pid):
        return self.collection[str(pid)]

    def __iter__(self):
        return iter(self.collection.items())

    def batch_iter(self, batch_size: int) -> Iterator[List[Tuple[str, str]]]:
        batch: List[Tuple[str, str]] = []
        for item in self.collection.items():
            batch.append(item)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch


class MSMarcoTriples:
    """(qid, pos_pid, neg_pid) training triples joined against queries and
    collection (reference datasets.py:99-135)."""

    def __init__(
        self, triples_path: PathLike, queries_path: PathLike, collection_path: PathLike
    ):
        self.triples: List[Tuple[str, str, str]] = []
        with open(triples_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                qid, pos, neg = line.rstrip("\n").split("\t")[:3]
                self.triples.append((str(qid), str(pos), str(neg)))
        self.queries = Queries(queries_path)
        self.collection = Collection(collection_path)

    def __len__(self):
        return len(self.triples)

    def __getitem__(self, idx) -> Tuple[str, str, str]:
        qid, pos_id, neg_id = self.triples[idx]
        return self.queries[qid], self.collection[pos_id], self.collection[neg_id]


class DistilHardNegatives(MSMarcoTriples):
    """5-column triples with teacher scores (reference datasets.py:225-248)."""

    def __init__(self, triples_path, queries_path, collection_path):
        self.triples = []
        with open(triples_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                parts = line.rstrip("\n").split("\t")
                self.triples.append(
                    (str(parts[0]), str(parts[1]), str(parts[2]), float(parts[3]), float(parts[4]))
                )
        self.queries = Queries(queries_path)
        self.collection = Collection(collection_path)

    def __getitem__(self, idx):
        qid, pos_id, neg_id, pos_score, neg_score = self.triples[idx]
        return (
            self.queries[qid],
            self.collection[pos_id],
            self.collection[neg_id],
            pos_score,
            neg_score,
        )


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


class TopKDataset:
    """Top-k file: qid \\t pid \\t query \\t passage (reference datasets.py:181-222)."""

    def __init__(self, top_k_path: PathLike):
        self.queries: Dict[str, str] = {}
        self.passages: Dict[str, str] = {}
        self.top_k: Dict[str, List[str]] = {}
        with open(top_k_path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                qid, pid, query, passage = line.rstrip("\n").split("\t")
                qid, pid = str(qid), str(pid)
                if qid in self.queries and self.queries[qid] != query:
                    raise AssertionError("TopK file is not in the expected format")
                self.queries[qid] = query
                self.passages[pid] = passage
                self.top_k.setdefault(qid, []).append(pid)
        if not all(len(v) == len(set(v)) for v in self.top_k.values()):
            raise AssertionError("TopK file contains duplicates")
        lens = [len(v) for v in self.top_k.values()]
        self.min_len, self.max_len = min(lens), max(lens)
        self.avg_len = round(sum(lens) / len(lens), 2)

    def __len__(self):
        return len(self.top_k)

    def __getitem__(self, qid):
        return self.top_k[str(qid)]

    def keys(self):
        return self.top_k.keys()


class _ScoresUnpickler(pickle.Unpickler):
    """A score map holds dicts, strings and numbers: refuse any other class
    (numpy scalars excepted), so a score file cannot run code."""

    _ALLOWED = {("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar"),
                ("numpy", "dtype")}

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"distillation scores: refusing {module}.{name}")


class DistillationScores:
    """Gzip-pickled {qid: {pid: teacher_score}} chunked into fixed-size score
    groups; with qrels -> MarginMSE layout [pos] + negatives, without ->
    KL layout (reference datasets.py:251-302)."""

    def __init__(
        self,
        scores_path: PathLike,
        queries_path: PathLike,
        collection_path: PathLike,
        batch_size: int = 55,
        qrels_path: Optional[PathLike] = None,
    ):
        self.batch_size = batch_size
        self.qrels = QueryRelevanceDataset(qrels_path) if qrels_path else None
        self.queries = Queries(queries_path)
        self.collection = Collection(collection_path)
        with gzip.open(scores_path, "rb") as f:
            scores = _ScoresUnpickler(f).load()
        self.dataset = self._construct(scores)

    def _construct(self, scores):
        lookup: List[Tuple[str, List[Tuple[str, float]]]] = []
        if self.qrels:
            for qid in self.qrels.keys():
                qid = str(qid)
                if qid not in scores:
                    continue
                positive_docs = [
                    (x, scores[qid].pop(x)) for x in self.qrels[qid] if x in scores[qid]
                ]
                negative_docs = list(scores[qid].items())
                for pos_doc in positive_docs:
                    for i in range(0, len(negative_docs), self.batch_size):
                        if i + self.batch_size <= len(negative_docs):
                            lookup.append(
                                (qid, [pos_doc] + negative_docs[i : i + self.batch_size])
                            )
                        else:
                            break
        else:
            for qid in scores:
                docs = list(scores[qid].items())
                for i in range(0, len(docs), self.batch_size):
                    lookup.append((str(qid), docs[i : i + self.batch_size]))
        return lookup

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        qid, pid_score_list = self.dataset[idx]
        return (
            self.queries[str(qid)],
            [(self.collection[str(pid)], score) for pid, score in pid_score_list],
        )


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


class TopKRunFile(RunFile):
    """A run file read back as each query's pids in rank order, the first
    ``k`` (the candidates ``evaluation.ReRanker`` rescores)."""

    def __init__(self, run_file_path: PathLike, k: int = 2000):
        super().__init__(run_file_path)
        top_k: Dict[str, List[Tuple[int, str]]] = {}
        for qid, pid, rank, _ in self.read():
            top_k.setdefault(qid, []).append((rank, pid))
        self.top_k: Dict[str, List[str]] = {}
        for qid, ranked in top_k.items():
            ranked.sort()
            self.top_k[qid] = [pid for _, pid in ranked[:k]]

    def __len__(self):
        return len(self.top_k)

    def __getitem__(self, qid):
        return self.top_k[str(qid)]

    def __iter__(self):
        return iter(self.top_k.items())
