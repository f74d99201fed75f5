from .config import (
    EncoderConfig,
    GenerationConfig,
    IndexConfig,
    MeshConfig,
    SearchConfig,
    TrainConfig,
)
from .device import resolve_device
from .logging import get_logger

__all__ = [
    "EncoderConfig",
    "GenerationConfig",
    "IndexConfig",
    "MeshConfig",
    "SearchConfig",
    "TrainConfig",
    "get_logger",
    "resolve_device",
]
