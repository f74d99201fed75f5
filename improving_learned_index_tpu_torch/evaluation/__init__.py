from .ranker import Ranker
from .run_metrics import MRR_DEPTHS, RECALL_DEPTHS, Metrics

__all__ = ["Ranker", "MRR_DEPTHS", "RECALL_DEPTHS", "Metrics"]
