from .dataloader import BatchLoader
from .distributed import initialize_distributed, rank_and_world, rank_collate, shard_groups

__all__ = [
    "BatchLoader",
    "initialize_distributed",
    "rank_and_world",
    "rank_collate",
    "shard_groups",
]
