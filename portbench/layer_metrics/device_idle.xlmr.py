"""The share of the XLM-R cell's traced ``index_to_file`` in which no
operation ran on the device."""


def read(readings):
    profile = readings.get("profile")
    return None if profile is None else 100.0 * profile.idle_share
