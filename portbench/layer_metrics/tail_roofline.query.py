"""The tail stage's share of its bound: the bound (each touched posting
read once, each touched 32-byte sector of the score matrix read and
written once) of the traced batches over the device time of
``csrc/scatter_scores.cu``'s kernels in them."""

from portbench.harness.roofline import bound_s, tail_bytes


def read(readings):
    profile = readings.get("profile")
    if profile is None:
        return None
    device_s = profile.device_s(files=("csrc/scatter_scores.cu",))
    if device_s <= 0:
        return None
    need = sum(bound_s(tail_bytes(b["tail_postings"], b["touched_sectors"]), 0.0, readings["kind"])
               for b in readings["inputs"] if b["tail_postings"])
    return 100.0 * need / device_s
