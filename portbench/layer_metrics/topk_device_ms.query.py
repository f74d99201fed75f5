"""The top-k's device time a batch over the traced batches: every kernel
launched inside the benchmark's span ``portbench/topk`` around the
engine's calls into ``ops/exact_topk.exact_topk_integer`` (its PyTorch
operations and ``csrc/count_ge.cu``)."""


def read(readings):
    profile = readings.get("profile")
    if profile is None or not profile.units:
        return None
    device_s = profile.device_s(files=("csrc/count_ge.cu",), regions=("portbench/topk",))
    return device_s / profile.units * 1e3 if device_s > 0 else None
