"""Building a batch's answer lists on the host, ms a batch: the
program's ``search/answers`` region in ``topk_to_host``'s finalizer, over
the traced batches."""

from portbench.harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.get("profile"), ("search/answers",))
