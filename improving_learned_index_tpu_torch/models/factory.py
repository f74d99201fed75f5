"""Named model factories matching the reference model families
(src/deep_impact/models/__init__.py: DeepImpact, DeepImpactXLMR); the port's
copy of the DeepImpact entries of
``improving_learned_index_tpu/models/factory.py``.  Pairwise and
cross-encoder models are not ported yet."""

from __future__ import annotations

from typing import Optional

from ..core.config import EncoderConfig
from .deep_impact import DeepImpact


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


# API-parity alias: the reference exports the XLM-R variant as a class name.
DeepImpactXLMR = deep_impact_xlmr
