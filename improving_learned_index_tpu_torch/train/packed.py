"""Sequence packing for the TRAINING path (the port's copy of
``improving_learned_index_tpu/train/packed.py``, numpy only: the same arrays
for the same input).

The training workload has the same shape problem as corpus encode: MSMARCO
triples/distillation passages average ~70 subword tokens but every document
is padded to max_length=256 (the reference collates call the tokenizer with
``padding='max_length'``, src/deep_impact/models/original.py:200-226), so
most training FLOPs hit padding.  The fix is the encode path's sequence
packing (text/packing.py) applied to the collated step batch:

- the N document rows of a collated batch are greedily packed, in order,
  into R rows of [S] with block-diagonal attention (segment ids) and
  per-segment position ids — the same device-side machinery as
  ``DeepImpact.encode_packed``, so per-token impact scores match the
  unpacked forward to fp tolerance (tests/test_packing.py);
- the per-document query-term masks ride along at the packed token
  positions, and the loss recovers per-document scores with ONE
  scatter-add over a ``doc_index`` map (padding slots point at a dummy
  N-th row that is sliced off) — exactly ``sum(mask * token_scores)`` per
  document, the reference objective (trainer.py:158-163), just summed in
  packed order;
- R is bucketed in ceil(N/16) steps up to N rows so batch shapes stay
  bounded across steps while wasting at most ~9% of rows to bucket
  padding.  Each data-parallel rank packs its own query groups
  (``parallel.distributed.rank_collate``), so the rows never have to split
  evenly over ranks (the JAX copy rounds buckets to its mesh's data axis).

Supported objectives: ``pairwise_ce``, ``distil_kl``, ``distil_mse`` —
every objective whose mask is per-document.  ``in_batch_negatives`` and
``pairwise_impact`` score each document under MANY query masks (their mask
arrays are per (query, document) pair in unpacked token coordinates), and
``cross_encoder`` reads the [CLS] position only — packing those is a
different transform and not worth it at their batch shapes; ``pack_collated``
rejects batches whose mask shape doesn't match the document rows.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def row_buckets(n_docs: int) -> Sequence[int]:
    """Row-count buckets for a batch of ``n_docs`` documents: multiples of
    ceil(N/16) up to N rows.  N rows always suffice —
    each document fits one row by construction.  Ladder granularity is a
    compile-count / padding-waste trade: a power-of-2 ladder measured 64
    rows for a 34-row batch (1.9x step speedup where ~3x was available);
    N/16 steps waste <= ~9% rows for <= 16 compiled shapes, and in practice
    a stationary doc-length distribution revisits only 1-2 of them."""

    step = -(-n_docs // 16)
    out = []
    for k in range(1, 17):
        b = max(1, min(k * step, n_docs))
        if not out or b > out[-1]:
            out.append(b)
        if b >= n_docs:
            break
    return out


def pack_collated(arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Pack a collated training batch (collate.py output) into packed-row
    arrays consumed by the packed loss in trainer.make_loss_fn.

    In: input_ids/attention_mask/type_ids [N, L] int32, masks [N, L]
    float32 (one query-term mask per document row), plus passthrough keys
    (scores, group_size).  Out: input_ids/segment_ids/type_ids/doc_index
    [R, S] with masks [R, S] float32, doc_base [N+1] float32 zeros (the
    scatter target; slot N collects padding), and the passthrough keys.
    Deterministic greedy in-order first-fit; documents must be
    right-padded (they are: the tokenizers pad right)."""
    ids = np.asarray(arrays["input_ids"], dtype=np.int32)
    att = np.asarray(arrays["attention_mask"], dtype=np.int32)
    typ = np.asarray(arrays["type_ids"], dtype=np.int32)
    masks = np.asarray(arrays["masks"], dtype=np.float32)
    n, seq = ids.shape
    if masks.shape != (n, seq):
        raise ValueError(
            f"packed training needs one mask per document row: masks "
            f"{masks.shape} vs encodings {(n, seq)} — this objective's "
            f"masks are per (query, document) pair; train unpacked"
        )
    lengths = att.sum(axis=1).astype(np.int64)
    if (lengths == 0).any():
        raise ValueError("zero-length document in training batch")
    # right-padding check (packing slices ids[:len]): a contiguous mask must
    # start at column 0 and end exactly at lengths-1 — a left- or mid-padded
    # row like [0,1,1,0] has the right popcount but would pack pad tokens.
    if (att[:, 0] != 1).any() or (
        att[np.arange(n), np.minimum(lengths - 1, seq - 1)] != 1
    ).any() or (att * (np.arange(seq)[None, :] >= lengths[:, None])).any():
        raise ValueError("sequence packing requires right-padded encodings")

    # greedy in-order fill: row/col cursor per document
    row_of = np.zeros(n, dtype=np.int64)
    col_of = np.zeros(n, dtype=np.int64)
    seg_of = np.zeros(n, dtype=np.int64)
    row, col, seg = 0, 0, 0
    for i in range(n):
        ln = int(lengths[i])
        if col + ln > seq:
            row, col, seg = row + 1, 0, 0
        row_of[i], col_of[i], seg_of[i] = row, col, seg + 1
        col += ln
        seg += 1
    need = row + 1
    for b in row_buckets(n):
        if need <= b:
            rows = b
            break
    else:  # pragma: no cover - buckets always end at >= n >= need
        rows = need

    out_ids = np.zeros((rows, seq), dtype=np.int32)
    out_seg = np.zeros((rows, seq), dtype=np.int32)
    out_typ = np.zeros((rows, seq), dtype=np.int32)
    out_msk = np.zeros((rows, seq), dtype=np.float32)
    out_doc = np.full((rows, seq), n, dtype=np.int32)  # padding -> dummy slot
    for i in range(n):
        r, c, ln = int(row_of[i]), int(col_of[i]), int(lengths[i])
        out_ids[r, c : c + ln] = ids[i, :ln]
        out_seg[r, c : c + ln] = seg_of[i]
        out_typ[r, c : c + ln] = typ[i, :ln]
        out_msk[r, c : c + ln] = masks[i, :ln]
        out_doc[r, c : c + ln] = i

    packed = {
        "input_ids": out_ids,
        "segment_ids": out_seg,
        "type_ids": out_typ,
        "masks": out_msk,
        "doc_index": out_doc,
        "doc_base": np.zeros(n + 1, dtype=np.float32),
    }
    for k, v in arrays.items():
        if k not in ("input_ids", "attention_mask", "type_ids", "masks"):
            packed[k] = v
    return packed


PACKABLE_LOSSES = ("pairwise_ce", "distil_kl", "distil_mse")


def packing_collate(base_collate):
    """Wrap a collate fn so every batch comes out packed."""

    def collate(batch, *args, **kwargs):
        return pack_collated(base_collate(batch, *args, **kwargs))

    return collate
