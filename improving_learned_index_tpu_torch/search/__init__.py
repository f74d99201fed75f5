from .dense_engine import DenseSearchEngine
from .device_engine import DeviceSearchEngine
from .engine import InvertedIndex
from .hybrid_engine import HybridSearchEngine
from .native import NativeSearchEngine
from .select import build_engine, choose_engine
from .sharded_engine import ShardedSearchEngine

__all__ = [
    "DenseSearchEngine",
    "DeviceSearchEngine",
    "HybridSearchEngine",
    "InvertedIndex",
    "NativeSearchEngine",
    "ShardedSearchEngine",
    "build_engine",
    "choose_engine",
]
