from .hybrid_engine import HybridSearchEngine
from .select import build_engine

__all__ = ["HybridSearchEngine", "build_engine"]
