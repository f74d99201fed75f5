"""Every passage written to the forward index over the whole window, the
pipeline's fill and drain included: the rate a user of ``cli.index`` sees.
The host paces it, so it swings with the host from run to run."""


def read(readings):
    docs, window = readings.get("window_docs"), readings.get("window_s")
    return docs / window if docs and window else None
