from .datasets import (
    Collection,
    CollectionParser,
    DistilHardNegatives,
    DistillationScores,
    MSMarcoTriples,
    Queries,
    QueryParser,
    QueryRelevanceDataset,
    RunFile,
    stream_collection,
)

__all__ = [
    "Collection",
    "CollectionParser",
    "DistilHardNegatives",
    "DistillationScores",
    "MSMarcoTriples",
    "Queries",
    "QueryParser",
    "QueryRelevanceDataset",
    "RunFile",
    "stream_collection",
]
