"""The yardstick's arithmetic: the chip's peaks, and the bytes and
operations a stage's inputs need, whatever implements the stage.

Each count is of what the batch's inputs need: every input byte read once,
every output byte written once, operations as the mathematics has them.
A kernel that reads more, or a later kernel that replaces it, leaves the
count as it is.  A share of a bound is the bound's time over the measured
time: it cannot pass 100% unless a count here is too high or the measured
time leaves part of the work out.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

# NVIDIA's data sheet for the H100 SXM (dense rates, no sparsity, at the
# 700 W limit).  The card's own power limit is printed beside every run.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "bf16_flops": 989e12, "fp32_flops": 67e12},
}
DEFAULT_KIND = "NVIDIA H100 80GB HBM3"


def peaks(kind: str) -> Dict[str, float]:
    return PEAKS.get(kind, PEAKS[DEFAULT_KIND])


def bound_s(bytes_moved: float, flops: float, kind: str, flops_key: str = "bf16_flops") -> float:
    """The least time the chip could take: the larger of bytes over peak
    bandwidth and operations over peak rate."""
    p = peaks(kind)
    return max(bytes_moved / p["hbm_bytes_per_s"], flops / p[flops_key])


# -- the query path -------------------------------------------------------------

POSTING_BYTES = 5  # uint32 doc id + uint8 impact, the index's own format
SCORE_BYTES = 4    # an fp32 (exact integer) score a doc
DENSE_CELL_BYTES = 2  # a heavy term's dense row holds bf16 impacts (exact to 256)
SECTOR_BYTES = 32  # the unit device memory moves


def heavy_bytes(hit_rows: int, nq: int, num_docs: int) -> float:
    """The heavy stage: each dense row the batch hits read once, the
    [nq, num_docs] score matrix written once."""
    return hit_rows * num_docs * DENSE_CELL_BYTES + nq * num_docs * SCORE_BYTES


def tail_bytes(postings: int, touched_sectors: int) -> float:
    """The tail stage: each touched posting read once, each touched sector
    of the score matrix read and written once."""
    return postings * POSTING_BYTES + touched_sectors * SECTOR_BYTES * 2


def topk_bytes(nq: int, num_docs: int) -> float:
    """The top-k: the score matrix read once."""
    return nq * num_docs * SCORE_BYTES


# -- the encoder ------------------------------------------------------------------


def encoder_params(config: Dict) -> Dict[str, int]:
    """Parameter counts of a BERT-geometry trunk and its one-output head."""
    h, f, n = config["hidden_size"], config["intermediate_size"], config["num_hidden_layers"]
    layer = 4 * (h * h + h) + (h * f + f) + (f * h + h) + 4 * h
    embedding = (config["vocab_size"] + config["max_position_embeddings"] + config["type_vocab_size"]) * h
    return {"non_embedding": n * layer + 2 * h + (h + 1), "embedding": embedding}


def encoder_flops(lengths: Iterable[int], config: Dict) -> float:
    """Forward model FLOPs of passages of ``lengths`` real tokens, each
    attending only within itself: 2 x the non-embedding parameters a token,
    plus 4 x hidden x L^2 a layer for the logits and the context."""
    per_token = 2 * encoder_params(config)["non_embedding"]
    h, n = config["hidden_size"], config["num_hidden_layers"]
    total = 0.0
    for length in lengths:
        total += per_token * length + 4.0 * h * n * length * length
    return total


def attention_bound_s(lengths: Sequence[int], config: Dict, kind: str) -> float:
    """One layer's attention over passages of ``lengths`` real tokens: q,
    k, v (bf16) and the segment ids (int32) read once, the context (bf16)
    written once; 4 x hidden x L^2 operations a passage."""
    h = config["hidden_size"]
    tokens = float(sum(lengths))
    bytes_moved = tokens * h * 2 * 4 + tokens * 4
    flops = sum(4.0 * h * length * length for length in lengths)
    return bound_s(bytes_moved, flops, kind)
