"""The top-k's host syncs a batch: the program's ``search/topk_sync``
regions, one around each convergence test of ``exact_topk_integer``'s
search (a bool read back to the host), over the traced batches."""

from portbench.harness.spans import count_per_unit


def read(readings):
    return count_per_unit(readings.get("profile"), ("search/topk_sync",))
