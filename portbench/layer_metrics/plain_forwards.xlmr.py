"""The encoder's plain-attention forwards a batch: the program's
``encoder/route_plain`` regions over its ``index/encode`` regions in the
traced ``index_to_file``.  0 where batches ran and every forward took
another route; None where the program names no ``encoder/route_*``
region at all (it has none) or ran no batch."""

ROUTES = ("encoder/route_short", "encoder/route_flash", "encoder/route_plain")


def read(readings):
    profile = readings.get("profile")
    if profile is None:
        return None
    names = [name for _, _, name in profile.host]
    batches = names.count("index/encode")
    if not batches or not any(name in ROUTES for name in names):
        return None
    return names.count("encoder/route_plain") / batches
