"""The trainer's wait for its next batch, ms a step: the program's
``train/next_batch`` regions (the pull from the loader, and the pull that
ends the loop) over the traced steps."""

from portbench.harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.get("profile"), ("train/next_batch",))
