from .dataloader import BatchLoader
from .distributed import initialize_distributed, rank_and_world, rank_collate, shard_groups
from .multidevice import dryrun_multidevice

__all__ = [
    "BatchLoader",
    "dryrun_multidevice",
    "initialize_distributed",
    "rank_and_world",
    "rank_collate",
    "shard_groups",
]
