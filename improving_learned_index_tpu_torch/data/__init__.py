from .datasets import Queries, QueryParser, QueryRelevanceDataset, RunFile

__all__ = ["Queries", "QueryParser", "QueryRelevanceDataset", "RunFile"]
