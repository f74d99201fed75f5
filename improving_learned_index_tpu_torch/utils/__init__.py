from .sorting import radix_argsort
from .text_utils import expand_pairwise_terms

__all__ = ["expand_pairwise_terms", "radix_argsort"]
