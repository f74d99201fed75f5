from .forward_index import (
    ForwardIndex,
    PairwiseForwardIndex,
    format_line,
    format_quantized_line,
    iter_forward_index,
    parse_line,
    quantize_file,
)
from .indexer import Indexer
from .inverted import InvertedIndexData, index_from_numpy

__all__ = [
    "ForwardIndex",
    "PairwiseForwardIndex",
    "format_line",
    "format_quantized_line",
    "iter_forward_index",
    "parse_line",
    "quantize_file",
    "Indexer",
    "InvertedIndexData",
    "index_from_numpy",
]
