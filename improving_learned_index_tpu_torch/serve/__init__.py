from .server import RetrievalServer

__all__ = ["RetrievalServer"]
