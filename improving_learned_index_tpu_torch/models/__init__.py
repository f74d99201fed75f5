from .deep_impact import DeepImpact, HostCopy
from .encoder import DeepImpactModel, ImpactHead, TransformerEncoder, init_weights
from .factory import DeepImpactXLMR, deep_impact, deep_impact_phobert, deep_impact_xlmr
from .hf_import import flax_params_to_port, hf_deep_impact_to_port, load_hf_checkpoint

__all__ = [
    "DeepImpact",
    "HostCopy",
    "DeepImpactModel",
    "ImpactHead",
    "TransformerEncoder",
    "init_weights",
    "DeepImpactXLMR",
    "deep_impact",
    "deep_impact_phobert",
    "deep_impact_xlmr",
    "flax_params_to_port",
    "hf_deep_impact_to_port",
    "load_hf_checkpoint",
]
