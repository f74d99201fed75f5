"""The share of the plain-traced window in which no operation ran on the
device, over whole ``score_stream`` runs of the query mix."""


def read(readings):
    profile = readings.get("profile")
    return None if profile is None else 100.0 * profile.idle_share
