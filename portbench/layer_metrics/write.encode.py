"""The share of the traced ``index_to_file`` spent formatting and writing
the forward file's lines: the program's ``index/write`` regions over the
window, in %."""

from portbench.harness.spans import window_share


def read(readings):
    return window_share(readings.get("profile"), ("index/write",))
