from .forward_index import ForwardIndex, iter_forward_index, quantize_file
from .indexer import Indexer
from .inverted import InvertedIndexData, index_from_numpy

__all__ = [
    "ForwardIndex",
    "iter_forward_index",
    "quantize_file",
    "Indexer",
    "InvertedIndexData",
    "index_from_numpy",
]
