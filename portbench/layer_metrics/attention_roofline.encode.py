"""Attention's share of its bound: the bound of every layer's attention
over the real tokens of the traced passages (q, k, v, segment ids read
once, the context written once; the logits and context products within
each passage) over the device time of ``csrc/short_attention.cu``'s
kernels."""

from portbench.harness.roofline import attention_bound_s


def read(readings):
    profile = readings.get("profile")
    tokens = readings.get("profile_tokens")
    if profile is None or not tokens:
        return None
    device_s = profile.device_s(files=("csrc/short_attention.cu",))
    if device_s <= 0:
        return None
    layers = readings["config"]["num_hidden_layers"]
    return 100.0 * layers * attention_bound_s(tokens, readings["config"], readings["kind"]) / device_s
