from .inverted import InvertedIndexData, index_from_numpy

__all__ = ["InvertedIndexData", "index_from_numpy"]
