from .sorting import radix_argsort
from .text_utils import expand_pairwise_terms, get_unique_query_terms, merge_document_and_queries

__all__ = [
    "expand_pairwise_terms",
    "get_unique_query_terms",
    "merge_document_and_queries",
    "radix_argsort",
]
