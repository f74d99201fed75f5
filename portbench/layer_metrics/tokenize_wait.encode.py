"""The share of the traced ``index_to_file`` that its consumer waited on
the tokenizer thread: the program's ``index/next_batch`` regions over the
window, in %."""

from portbench.harness.spans import window_share


def read(readings):
    return window_share(readings.get("profile"), ("index/next_batch",))
