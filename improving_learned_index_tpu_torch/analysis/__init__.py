from .attention import extract_term_pair_attention

__all__ = ["extract_term_pair_attention"]
