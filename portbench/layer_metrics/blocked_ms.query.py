"""The host blocked on the card, ms a batch: the program's
``search/topk_sync`` regions (the top-k's convergence reads) and
``search/result_wait`` (the wait for the batch's answers to reach the
host), over the traced batches."""

from portbench.harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.get("profile"), ("search/topk_sync", "search/result_wait"))
