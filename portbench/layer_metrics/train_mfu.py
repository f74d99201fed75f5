"""Training's share of the chip's bf16 peak over the traced run's window:
3 x the forward model FLOPs (2 x the non-embedding parameters a real
token, plus the attention within each document) of every document of
every step, over (window x peak)."""

from portbench.harness.roofline import encoder_flops, peaks


def read(readings):
    tokens = readings.get("window_tokens")
    if not tokens:
        return None
    flops = 3 * encoder_flops(tokens, readings["config"])
    return 100.0 * flops / (readings["window_s"] * peaks(readings["kind"])["bf16_flops"])
