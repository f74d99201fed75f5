"""Named model factories matching the reference model families
(src/deep_impact/models/__init__.py: DeepImpact, DeepImpactXLMR,
DeepPairwiseImpact, DeepImpactCrossEncoder); the port's copy of
``improving_learned_index_tpu/models/factory.py``."""

from __future__ import annotations

from typing import Optional

from ..core.config import EncoderConfig
from .deep_impact import DeepImpact, DeepImpactCrossEncoder
from .pairwise import DeepPairwiseImpact


def deep_impact(tokenizer, config: Optional[EncoderConfig] = None, **kw) -> DeepImpact:
    """BERT-base trunk + ReLU head (CoCondenser-init family,
    reference models/original.py upstream path)."""
    return DeepImpact(config or EncoderConfig.bert_base(), tokenizer, **kw)


def deep_impact_xlmr(tokenizer, config: Optional[EncoderConfig] = None, **kw) -> DeepImpact:
    """xlm-roberta-base trunk + Softplus head, max_length 512
    (reference models/xlmr_original.py)."""
    return DeepImpact(config or EncoderConfig.xlmr_base(), tokenizer, **kw)


def deep_impact_phobert(tokenizer, config: Optional[EncoderConfig] = None, **kw) -> DeepImpact:
    """vinai/phobert-base-v2 trunk + ReLU head, max_length 256 (the fork's
    Vietnamese default, reference models/original.py:18-48)."""
    return DeepImpact(config or EncoderConfig.phobert_base(), tokenizer, **kw)


def deep_pairwise_impact(
    tokenizer, config: Optional[EncoderConfig] = None, **kw
) -> DeepPairwiseImpact:
    return DeepPairwiseImpact(config or EncoderConfig.bert_base(), tokenizer, **kw)


def deep_impact_cross_encoder(
    tokenizer, config: Optional[EncoderConfig] = None, **kw
) -> DeepImpactCrossEncoder:
    return DeepImpactCrossEncoder(config or EncoderConfig.bert_base(), tokenizer, **kw)


# API-parity alias: the reference exports the XLM-R variant as a class name.
DeepImpactXLMR = deep_impact_xlmr
