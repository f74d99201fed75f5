"""doc2query expansion, Llama route: generation, LoRA fine-tuning, merge.
(The T5 route and the precomputed-expansion tools are not ported yet.)"""

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
from .sampling import Sampler, top_k_top_p_filter

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
    "Sampler",
    "top_k_top_p_filter",
]
