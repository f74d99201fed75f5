"""doc2query expansion: the Llama route (generation, LoRA fine-tuning,
merge), the T5/mT5 route (``T5QueryGenerator``) and expansion from
precomputed query or term stores (doc2query--, TILDE)."""

from .generate import (
    PROMPT_EN,
    PROMPT_SEP,
    PROMPT_VI,
    QueryGenerator,
    WordTokenizer,
    count_lines,
    generate_expansions,
    load_local_generator,
    save_local_generator,
)
from .lora import LoraConfig, init_lora_params, lora_forward_params, merge_lora
from .merge import merge_collection_and_expansions
from .precomputed import expand_with_precomputed, load_scored_queries_jsonl, score_percentile_threshold, tilde_expand
from .sampling import Sampler, top_k_top_p_filter
from .t5_generate import T5QueryGenerator, T5Sampler

__all__ = [
    "PROMPT_EN",
    "PROMPT_SEP",
    "PROMPT_VI",
    "QueryGenerator",
    "WordTokenizer",
    "count_lines",
    "generate_expansions",
    "load_local_generator",
    "save_local_generator",
    "LoraConfig",
    "init_lora_params",
    "lora_forward_params",
    "merge_lora",
    "merge_collection_and_expansions",
    "expand_with_precomputed",
    "load_scored_queries_jsonl",
    "score_percentile_threshold",
    "tilde_expand",
    "Sampler",
    "top_k_top_p_filter",
    "T5QueryGenerator",
    "T5Sampler",
]
