from .dense_engine import DenseSearchEngine
from .device_engine import DeviceSearchEngine
from .engine import InvertedIndex
from .hybrid_engine import HybridSearchEngine
from .native import NativeSearchEngine
from .select import build_engine, choose_engine

__all__ = [
    "DenseSearchEngine",
    "DeviceSearchEngine",
    "HybridSearchEngine",
    "InvertedIndex",
    "NativeSearchEngine",
    "build_engine",
    "choose_engine",
]
