"""CLI: doc2query expansion generation
(reference: python -m src.llama2.generate, generate.py:120-206).

    python -m improving_learned_index_tpu_torch.cli.expand --collection_path c.tsv \
        --output_path expansions.jsonl (--local_path DIR | --llama_path HF_DIR | --tiny | --t5 HF_DIR) \
        [--peft_path adapter.msgpack] [--int8 | --int4] [--kv_quant int8] [--greedy] [--device cpu]

The Llama route: a local generator directory (``expand.save_local_generator``,
the JAX layout), a local HF Llama directory (``transformers``) or a tiny
random model; ``--peft_path`` merges a LoRA adapter msgpack
(``cli.finetune --output_adapter``) into the base; weight-only int8 /
packed-int4 quantization on the device; an int8 KV cache.  The T5/mT5 route
(``--t5``, reference ``python -m src.llama2.generate_t5``): a local HF T5 or
mT5 directory (``transformers``; the config, weights and tokenizer, with its
pad, EOS and decoder-start ids) through ``expand.T5QueryGenerator``, with
``--int8`` / ``--int4`` quantized on the device; the other model flags are
the Llama route's.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

from ..core.config import GenerationConfig
from ..core.device import resolve_device
from ..expand.generate import PROMPT_EN, PROMPT_VI, QueryGenerator, generate_expansions
from ..models.llama import LlamaConfig, init_llama_params, tree_to


class ByteTokenizer:
    """The ``--tiny`` model's tokenizer (the JAX CLI's): UTF-8 bytes + 3."""

    def encode(self, t):
        return [1] + [b + 3 for b in t.encode("utf-8")[:200]]

    def decode(self, ids):
        return bytes(i - 3 for i in ids if i >= 3).decode("utf-8", "ignore")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--collection_type", choices=["msmarco", "beir"], default="msmarco")
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--llama_path", type=str, default=None,
                        help="local HF Llama checkpoint dir (weights + tokenizer)")
    parser.add_argument("--local_path", type=str, default=None,
                        help="local generator dir written by expand.save_local_generator")
    parser.add_argument("--peft_path", type=str, default=None,
                        help="LoRA adapter msgpack (Doc2QueryFineTuner.save_adapter) to merge into the base")
    parser.add_argument("--prompt", choices=["en", "vi"], default="en")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--num_docs", type=int, default=None)
    parser.add_argument("--num_return_sequences", type=int, default=80)
    parser.add_argument("--max_new_tokens", type=int, default=50)
    parser.add_argument("--top_k", type=int, default=50)
    parser.add_argument("--top_p", type=float, default=0.95)
    parser.add_argument("--max_tokens", type=int, default=350)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--greedy", action="store_true", help="argmax decode instead of top-k/top-p sampling")
    parser.add_argument("--int8", action="store_true", help="weight-only int8 decode")
    parser.add_argument("--int4", action="store_true", help="packed 4-bit weight-only decode")
    parser.add_argument("--kv_quant", choices=["none", "int8"], default="none",
                        help="int8 KV cache (per-token/head scales)")
    parser.add_argument("--tiny", action="store_true", help="tiny random model (smoke)")
    parser.add_argument("--t5", type=str, default=None, metavar="MODEL",
                        help="local HF T5/mT5 checkpoint dir (e.g. an mT5 doc2query model) instead of Llama")
    parser.add_argument("--device", default=None, help="torch device; default cuda (cpu only when asked for)")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    gen_cfg = GenerationConfig(
        num_return_sequences=args.num_return_sequences,
        max_new_tokens=args.max_new_tokens,
        top_k=args.top_k,
        top_p=args.top_p,
        max_tokens=args.max_tokens,
        do_sample=not args.greedy,
    )
    if args.t5:
        return _t5_main(args, gen_cfg, device)
    pad_id, eos_id = 0, 2
    if args.local_path:
        from ..expand.generate import load_local_generator

        params, config, tokenizer = load_local_generator(args.local_path)
        config = dataclasses.replace(config, kv_quant=args.kv_quant)
    elif args.tiny:
        config = dataclasses.replace(LlamaConfig.tiny(vocab_size=259), kv_quant=args.kv_quant)
        params = init_llama_params(config, seed=args.seed)
        tokenizer = ByteTokenizer()
    else:
        if not args.llama_path:
            raise SystemExit("--llama_path required (or --local_path, or --tiny for a smoke run)")
        from ..models.llama import load_hf_llama

        params, config, tokenizer, eos_id = load_hf_llama(args.llama_path, kv_quant=args.kv_quant)
    if args.peft_path:
        from ..expand.finetune import load_adapter
        from ..expand.lora import LoraConfig, merge_lora

        params = merge_lora(params, load_adapter(args.peft_path), LoraConfig())

    params = tree_to(params, device)
    if args.int8 or args.int4:
        from ..models.quantization import quantize_params_int4, quantize_params_int8

        params = (quantize_params_int4 if args.int4 else quantize_params_int8)(params)

    generator = QueryGenerator(
        params, config, tokenizer, gen_cfg,
        prompt_template=PROMPT_VI if args.prompt == "vi" else PROMPT_EN,
        pad_token_id=pad_id, eos_token_id=eos_id, device=device,
    )
    n = generate_expansions(generator, args.collection_path, args.output_path, args.collection_type,
                            batch_size=args.batch_size, num_docs=args.num_docs, seed=args.seed)
    print(f"expanded {n} documents -> {args.output_path}")
    return 0


def _t5_main(args, gen_cfg: GenerationConfig, device) -> int:
    """The T5/mT5 route (the JAX CLI's ``_t5_main``)."""
    from ..expand.t5_generate import T5QueryGenerator
    from ..models.t5 import load_hf_t5

    params, config, tokenizer, ids = load_hf_t5(args.t5)
    params = tree_to(params, device)
    if args.int8 or args.int4:
        from ..models.quantization import quantize_params_int4, quantize_params_int8

        params = (quantize_params_int4 if args.int4 else quantize_params_int8)(params)
    generator = T5QueryGenerator(params, config, tokenizer, gen_cfg, device=device, **ids)
    n = generate_expansions(generator, args.collection_path, args.output_path, args.collection_type,
                            batch_size=args.batch_size, num_docs=args.num_docs, seed=args.seed)
    print(f"expanded {n} documents -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
