"""The share of the traced ``index_to_file`` spent reading a batch's
impacts back to the host (a wait on the card): the program's
``index/scores_to_host`` regions over the window, in %."""

from portbench.harness.spans import window_share


def read(readings):
    return window_share(readings.get("profile"), ("index/scores_to_host",))
