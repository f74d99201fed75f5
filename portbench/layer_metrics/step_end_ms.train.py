"""A step's end on the host, ms a step: the program's ``train/step_end``
regions over the traced steps.  A region runs from the loss's read back to
the host, which waits for the forward and backward, through the
optimizer's launch (its own ``train/optimizer`` region nests inside), the
checkpoint manager's step and the metrics record."""

from portbench.harness.spans import ms_per_unit


def read(readings):
    return ms_per_unit(readings.get("profile"), ("train/step_end",))
