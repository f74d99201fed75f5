from .bm25 import BM25Index
from .nano_beir import BaseEvaluator, NanoBEIREvaluator, load_local_beir_dir
from .ranker import Ranker
from .reranker import CrossEncoderReRanker, ReRanker
from .run_metrics import MRR_DEPTHS, RECALL_DEPTHS, Metrics
from .sparse_search import SparseSearch
from .trec_metrics import evaluate as trec_evaluate

__all__ = [
    "BM25Index",
    "BaseEvaluator",
    "NanoBEIREvaluator",
    "load_local_beir_dir",
    "Ranker",
    "CrossEncoderReRanker",
    "ReRanker",
    "MRR_DEPTHS",
    "RECALL_DEPTHS",
    "Metrics",
    "SparseSearch",
    "trec_evaluate",
]
