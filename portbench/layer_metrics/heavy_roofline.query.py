"""The heavy stage's share of its bound: the bound (each hit dense row
read once, the score matrix written once, at the chip's bandwidth) of the
traced batches over the device time of ``csrc/gather_rows.cu``'s kernels
in them."""

from portbench.harness.roofline import bound_s, heavy_bytes


def read(readings):
    profile = readings.get("profile")
    if profile is None:
        return None
    device_s = profile.device_s(files=("csrc/gather_rows.cu",))
    if device_s <= 0:
        return None
    need = sum(bound_s(heavy_bytes(b["hit_rows"], b["nq"], readings["num_docs"]), 0.0, readings["kind"])
               for b in readings["inputs"] if b["hit_rows"])
    return 100.0 * need / device_s
