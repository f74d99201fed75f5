"""Typed configuration layer.

The PyTorch port's own copy of ``improving_learned_index_tpu/core/config.py``
(no framework code inside), kept field for field so both packages read the
same configs and write the same on-disk index format.  The encoder fields
drive the port's encoder (``models/encoder.py``) as they drive the JAX
package's.

The reference scatters constants through ``src/utils/defaults.py`` (absolute
paths, binary formats, CUDA device strings).  Here every subsystem takes a
dataclass config; no absolute-path defaults, no device strings.

Binary index format constants mirror the reference layout exactly
(reference: src/utils/defaults.py:22-37, src/deep_impact/inverted_index/create.py:44-51)
so indexes serialize bit-for-bit compatibly:
  - postings record: uint32 doc_id (little-endian '<I') + uint8 impact ('B')
  - offsets record : two uint64 ('<QQ') [start_byte, end_byte) per term
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Inverted-index binary layout (parity with the reference on-disk format).
# ---------------------------------------------------------------------------
INVERTED_INDEX_VOCAB = "vocab.txt"
INVERTED_INDEX_INDEX = "inverted_index.idx"
INVERTED_INDEX_DATA = "inverted_index.dat"

IMPACT_SCORE_QUANTIZATION_BITS = 8
IMPACT_SCORE_FORMAT = "B"  # uint8
IMPACT_SCORE_BYTES = 1
DOC_ID_FORMAT = "I"  # uint32
DOC_ID_BYTES = 4
LOC_FORMAT = "Q"  # uint64
LOC_BYTES = 8

DOC_SCORE_BLOCK_FORMAT = DOC_ID_FORMAT + IMPACT_SCORE_FORMAT
DOC_SCORE_BLOCK_BYTES = DOC_ID_BYTES + IMPACT_SCORE_BYTES
LOC_BLOCK_FORMAT = LOC_FORMAT * 2
LOC_BLOCK_BYTES = LOC_BYTES * 2

COLLECTION_TYPES = ("msmarco", "beir")

# doc2query generation defaults (reference: src/utils/defaults.py:41-45).
DEFAULT_TOP_K = 50
DEFAULT_TOP_P = 0.95
DEFAULT_MAX_NEW_TOKENS = 50
DEFAULT_MAX_TOKENS = 350
DEFAULT_NUM_RETURN_SEQUENCES = 80


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Transformer encoder trunk + impact head.

    Matches HF BERT/RoBERTa/XLM-R geometry so weights import directly.
    """

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    pad_token_id: int = 0
    # RoBERTa-family tokenizers offset position ids by pad_token_id + 1.
    position_offset: int = 0
    # Impact head activation: 'relu' (DeepImpact, reference original.py:44-47)
    # or 'softplus' (XLM-R variant, reference xlmr_original.py:34-38).
    impact_activation: str = "relu"
    # Compute dtype for matmuls (params stay fp32).
    dtype: str = "bfloat16"
    # Short-sequence attention (ops/short_attention.py): with a mask, S <= 256,
    # S % 128 == 0 and head dim % 8 == 0 the encoder calls the hand-written
    # kernel (csrc/short_attention.cu on the card), which keeps the fp32
    # [S, S] logits out of device memory; otherwise plain torch attention.
    # The backward recomputes through the JAX package's XLA-route math.
    use_short_attention: bool = True
    # The JAX package's library flash-attention route (off by default): where
    # short attention does not apply and S % 128 == 0, ops.flash_attention
    # (csrc/flash_attention.cu on the card, head dim 64 or 128).
    use_flash_attention: bool = False

    @staticmethod
    def tiny(vocab_size: int = 512, impact_activation: str = "relu") -> "EncoderConfig":
        """Small config for tests/CI."""
        return EncoderConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
            impact_activation=impact_activation,
            hidden_dropout=0.0,
            attention_dropout=0.0,
        )

    @staticmethod
    def bert_base(**kw) -> "EncoderConfig":
        return EncoderConfig(**kw)

    @staticmethod
    def xlmr_base(**kw) -> "EncoderConfig":
        base = dict(
            vocab_size=250002,
            max_position_embeddings=514,
            type_vocab_size=1,
            layer_norm_eps=1e-5,
            pad_token_id=1,
            position_offset=2,
            impact_activation="softplus",
        )
        base.update(kw)
        return EncoderConfig(**base)

    @staticmethod
    def phobert_base(**kw) -> "EncoderConfig":
        base = dict(
            vocab_size=64001,
            max_position_embeddings=258,
            type_vocab_size=1,
            layer_norm_eps=1e-5,
            pad_token_id=1,
            position_offset=2,
            impact_activation="relu",
        )
        base.update(kw)
        return EncoderConfig(**base)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical device mesh. data axis: batch sharding; model axis: TP."""

    data: int = -1  # -1 = all remaining devices
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16  # per-replica examples (query groups)
    lr: float = 3e-6
    seed: int = 42
    max_length: int = 256
    grad_accumulation_steps: int = 1
    grad_clip_norm: float = 2.0
    save_every: int = 20000
    eval_every: int = 500
    save_best: bool = True
    weight_decay: float = 0.01
    # group size: docs per query group (2 for triples; 1+n for distillation).
    group_size: int = 2
    loss: str = "pairwise_ce"  # pairwise_ce | distil_kl | distil_mse | in_batch_negatives | cross_encoder


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    max_length: int = 512
    max_terms: int = 512  # term slots per document (<= max_length)
    model_batch_size: int = 32
    quantization_bits: int = IMPACT_SCORE_QUANTIZATION_BITS
    round_decimals: int = 3  # forward-index score rounding (reference indexer.py:64)
    # Sequence packing (text/packing.py): pack several short documents per
    # [max_length] row with block-diagonal attention.  Same scores, ~
    # (max_length / mean_doc_tokens)x fewer encode FLOPs on real corpora;
    # model_batch_size then counts packed ROWS per device batch.
    pack_sequences: bool = False


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    top_k: int = 1000
    query_batch_size: int = 64
    max_query_terms: int = 64
    # HBM budget (bytes) for the dense per-query score accumulators.
    score_memory_budget: int = 2 << 30
    # TPU hardware-friendly approximate top-k (jax.lax.approx_max_k):
    # measured 7.4x faster than exact top_k at 1M docs/k=1000 with 0.984
    # recall.  Off by default (exact parity); turn on for large-scale
    # serving where rank-1000 tail noise is irrelevant.
    approx_top_k: bool = False
    approx_recall_target: float = 0.99


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    """doc2query sampling (reference: src/utils/defaults.py:41-45, README.md:38-50)."""

    num_return_sequences: int = DEFAULT_NUM_RETURN_SEQUENCES
    max_new_tokens: int = DEFAULT_MAX_NEW_TOKENS
    top_k: int = DEFAULT_TOP_K
    top_p: float = DEFAULT_TOP_P
    max_tokens: int = DEFAULT_MAX_TOKENS
    temperature: float = 1.0
    do_sample: bool = True
