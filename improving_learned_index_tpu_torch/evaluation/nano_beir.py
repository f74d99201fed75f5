"""NanoBEIR evaluation harness (13 datasets).

Counterpart of ``improving_learned_index_tpu/evaluation/nano_beir.py``,
with the reference NanoBEIREvaluator's capability
(src/deep_impact/evaluation/nano_beir_evaluator.py:139-243): loads each
dataset's corpus/queries/qrels, runs SparseSearch at k=1000 on the model's
device, computes NDCG/MAP/Recall/P @ {10,100,1000} with trec_eval's tie
order, and averages across datasets.

Data sources (in order):
1. a local directory tree ``<root>/<dataset>/{corpus,queries,qrels}`` in
   BEIR jsonl/tsv format (hermetic, zero-network);
2. the HuggingFace hub (``zeta-alpha-ai/Nano*``) via ``datasets`` when
   network + package are available (the reference's source).  A dataset
   named but absent from the local directory takes this route.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

from ..core.logging import get_logger
from .sparse_search import SparseSearch
from .trec_metrics import evaluate as trec_evaluate

logger = get_logger("nano_beir", stream=False)

DATASET_NAME_TO_ID = {
    "climatefever": "zeta-alpha-ai/NanoClimateFEVER",
    "dbpedia": "zeta-alpha-ai/NanoDBPedia",
    "fever": "zeta-alpha-ai/NanoFEVER",
    "fiqa2018": "zeta-alpha-ai/NanoFiQA2018",
    "hotpotqa": "zeta-alpha-ai/NanoHotpotQA",
    "msmarco": "zeta-alpha-ai/NanoMSMARCO",
    "nfcorpus": "zeta-alpha-ai/NanoNFCorpus",
    "nq": "zeta-alpha-ai/NanoNQ",
    "quoraretrieval": "zeta-alpha-ai/NanoQuoraRetrieval",
    "scidocs": "zeta-alpha-ai/NanoSCIDOCS",
    "arguana": "zeta-alpha-ai/NanoArguAna",
    "scifact": "zeta-alpha-ai/NanoSciFact",
    "touche2020": "zeta-alpha-ai/NanoTouche2020",
}

DATASET_NAME_TO_HUMAN = {
    "climatefever": "ClimateFEVER",
    "dbpedia": "DBPedia",
    "fever": "FEVER",
    "fiqa2018": "FiQA2018",
    "hotpotqa": "HotpotQA",
    "msmarco": "MSMARCO",
    "nfcorpus": "NFCorpus",
    "nq": "NQ",
    "quoraretrieval": "QuoraRetrieval",
    "scidocs": "SCIDOCS",
    "arguana": "ArguAna",
    "scifact": "SciFact",
    "touche2020": "Touche2020",
}


class Dataset:
    def __init__(self, queries, corpus, relevant_docs, name):
        self.queries = queries
        self.corpus = corpus
        self.relevant_docs = relevant_docs
        self.name = name


def load_local_beir_dir(path: Union[str, Path]) -> Dataset:
    """BEIR directory format: corpus.jsonl (_id/title/text), queries.jsonl
    (_id/text), qrels{.tsv,/test.tsv} (query-id \\t corpus-id \\t score)."""
    path = Path(path)
    corpus: Dict[str, str] = {}
    with open(path / "corpus.jsonl", encoding="utf-8") as f:
        for line in f:
            item = json.loads(line)
            text = (item.get("title", "") + " " + item.get("text", "")).strip()
            if text:
                corpus[str(item["_id"])] = text
    queries: Dict[str, str] = {}
    with open(path / "queries.jsonl", encoding="utf-8") as f:
        for line in f:
            item = json.loads(line)
            if item.get("text"):
                queries[str(item["_id"])] = item["text"]
    qrels_file = path / "qrels.tsv"
    if not qrels_file.exists():
        qrels_file = path / "qrels" / "test.tsv"
    qrels: Dict[str, Dict[str, int]] = {}
    with open(qrels_file, encoding="utf-8") as f:
        for i, line in enumerate(f):
            parts = line.rstrip("\n").split("\t")
            if i == 0 and not parts[-1].isdigit():
                continue  # header
            qid, did = str(parts[0]), str(parts[1])
            rel = int(parts[2]) if len(parts) > 2 else 1
            qrels.setdefault(qid, {})[did] = rel
    return Dataset(queries, corpus, qrels, path.name)


def load_hf_nano_dataset(dataset_name: str) -> Dataset:
    """Load from the HF hub (gated on the ``datasets`` package + network)."""
    from datasets import load_dataset  # gated import

    dataset_path = DATASET_NAME_TO_ID[dataset_name.lower()]
    corpus_ds = load_dataset(dataset_path, "corpus", split="train")
    queries_ds = load_dataset(dataset_path, "queries", split="train")
    qrels_ds = load_dataset(dataset_path, "qrels", split="train")
    corpus = {s["_id"]: s["text"] for s in corpus_ds if len(s["text"]) > 0}
    queries = {s["_id"]: s["text"] for s in queries_ds if len(s["text"]) > 0}
    qrels: Dict[str, Dict[str, int]] = {}
    for s in qrels_ds:
        qrels.setdefault(s["query-id"], {})[s["corpus-id"]] = 1
    return Dataset(queries, corpus, qrels, DATASET_NAME_TO_HUMAN[dataset_name])


class BaseEvaluator:
    def __init__(self, batch_size: int = 16, verbose: bool = False):
        self.batch_size = batch_size
        self.verbose = verbose

    def _load_dataset(self, dataset_name: str) -> Dataset:
        raise NotImplementedError

    def evaluate_dataset(self, model, dataset_name: str):
        raise NotImplementedError

    def evaluate_all(self, model):
        raise NotImplementedError


class NanoBEIREvaluator(BaseEvaluator):
    def __init__(
        self,
        batch_size: int = 16,
        verbose: bool = False,
        local_data_dir: Optional[Union[str, Path]] = None,
        datasets: Optional[List[str]] = None,
        k_values: Tuple[int, ...] = (10, 100, 1000),
    ):
        super().__init__(batch_size, verbose)
        self.local_data_dir = local_data_dir or os.environ.get("ILI_TPU_NANO_BEIR_DIR")
        if datasets is None:
            if self.local_data_dir:
                # hermetic mode: evaluate exactly the datasets present locally
                datasets = sorted(
                    p.name
                    for p in Path(self.local_data_dir).iterdir()
                    if p.is_dir() and (p / "corpus.jsonl").exists()
                )
                if not datasets:
                    raise ValueError(
                        f"no BEIR-format datasets under {self.local_data_dir}"
                    )
                logger.info(f"local NanoBEIR datasets: {datasets}")
            else:
                datasets = list(DATASET_NAME_TO_ID.keys())
        self.datasets = datasets
        self.k_values = k_values

    def _load_dataset(self, dataset_name: str) -> Dataset:
        if self.local_data_dir:
            local = Path(self.local_data_dir) / dataset_name
            if local.exists():
                return load_local_beir_dir(local)
        return load_hf_nano_dataset(dataset_name)

    def evaluate_dataset(self, model, dataset_name: str):
        dataset = self._load_dataset(dataset_name)
        searcher = SparseSearch(model, batch_size=self.batch_size, verbose=self.verbose)
        results = searcher.search(dataset.queries, dataset.corpus, k=max(self.k_values))
        return trec_evaluate(dataset.relevant_docs, results, self.k_values)

    def evaluate_all(self, model):
        metrics = {}
        for name in self.datasets:
            if self.verbose:
                logger.info(f"evaluating {name}")
            metrics[name] = self.evaluate_dataset(model, name)
            if self.verbose:
                logger.info(f"{name}: {metrics[name]}")
        n = len(metrics)
        # Average per-metric across datasets (reference layout: 4-tuple of
        # dicts, nano_beir_evaluator.py:200-224).
        avg = tuple(
            {
                key: round(sum(metrics[d][i][key] for d in metrics) / n, 5)
                for key in next(iter(metrics.values()))[i]
            }
            for i in range(4)
        )
        metrics["avg"] = avg
        return metrics
