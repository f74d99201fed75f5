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
    TopKDataset,
    TopKRunFile,
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
    "TopKDataset",
    "TopKRunFile",
    "stream_collection",
]
