from .deep_impact import DeepImpact, DeepImpactCrossEncoder, HostCopy
from .encoder import CrossEncoderModel, DeepImpactModel, ImpactHead, TransformerEncoder, init_weights
from .factory import (
    DeepImpactXLMR,
    deep_impact,
    deep_impact_cross_encoder,
    deep_impact_phobert,
    deep_impact_xlmr,
    deep_pairwise_impact,
)
from .hf_import import flax_params_to_port, hf_deep_impact_to_port, load_hf_checkpoint
from .pairwise import DeepPairwiseImpact, PairwiseImpactModel, build_pair_slots

__all__ = [
    "DeepImpact",
    "DeepImpactCrossEncoder",
    "DeepPairwiseImpact",
    "HostCopy",
    "CrossEncoderModel",
    "DeepImpactModel",
    "PairwiseImpactModel",
    "ImpactHead",
    "TransformerEncoder",
    "build_pair_slots",
    "init_weights",
    "DeepImpactXLMR",
    "deep_impact",
    "deep_impact_cross_encoder",
    "deep_impact_phobert",
    "deep_impact_xlmr",
    "deep_pairwise_impact",
    "flax_params_to_port",
    "hf_deep_impact_to_port",
    "load_hf_checkpoint",
]
