"""Flash attention's share of its bound: the bound of every layer's
attention over the traced documents' segments (q, k, v and the segment ids
read once, the context written once; 4 x head dim operations a head over
the allowed pairs, each document's tokens with each other) over the device
time of ``csrc/flash_attention.cu``'s kernels.  None where no such kernel
ran."""

from portbench.harness.roofline import attention_bound_s


def read(readings):
    profile = readings.get("profile")
    tokens = readings.get("profile_tokens")
    if profile is None or not tokens:
        return None
    device_s = profile.device_s(files=("csrc/flash_attention.cu",))
    if device_s <= 0:
        return None
    layers = readings["config"]["num_hidden_layers"]
    return 100.0 * layers * attention_bound_s(tokens, readings["config"], readings["kind"]) / device_s
