"""The encoder's share of the chip's bf16 peak over the traced run's
window: model FLOPs of the real tokens of every passage written (2 x the
non-embedding parameters a token, plus the attention within each passage)
over (window x peak)."""

from portbench.harness.roofline import encoder_flops, peaks


def read(readings):
    tokens = readings.get("window_tokens")
    if not tokens:
        return None
    flops = encoder_flops(tokens, readings["config"])
    return 100.0 * flops / (readings["window_s"] * peaks(readings["kind"])["bf16_flops"])
