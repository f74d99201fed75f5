"""Putting a batch on the card, ms a step: the program's
``train/put_batch`` regions (pinning each tensor, the copies queued) over
the traced steps."""

from portbench.harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.get("profile"), ("train/put_batch",))
