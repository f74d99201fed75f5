from .datasets import (
    CollectionParser,
    Queries,
    QueryParser,
    QueryRelevanceDataset,
    RunFile,
    stream_collection,
)

__all__ = [
    "CollectionParser",
    "Queries",
    "QueryParser",
    "QueryRelevanceDataset",
    "RunFile",
    "stream_collection",
]
