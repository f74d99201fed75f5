"""CLI: doc2query LoRA fine-tuning
(reference: python src/llama2/finetune/finetune.py, finetune.py:195-216).

    python -m improving_learned_index_tpu_torch.cli.finetune --dataset_path pairs.tsv \
        --output_adapter adapter.msgpack (--llama_path HF_DIR | --tiny) \
        [--output_merged OUT] [--quantize_base int8|int4] [--variant trl_4bit] \
        [--enable_profiler] [--device cpu]

Input: ``document \\t query`` pairs (``scripts.prepare_dataset``'s output).
The adapter is written as a flax msgpack (the JAX package's bytes).
``--output_merged``: the base with the adapter merged, as a flax msgpack of
the parameter tree.  ``cli.expand --peft_path`` merges an adapter into its
base at load.  ``--enable_profiler`` writes a ``torch.profiler`` chrome
trace beside the adapter (``profile/trace.json``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..expand.finetune import Doc2QueryFineTuner
from ..expand.generate import PROMPT_EN, PROMPT_VI
from ..expand.lora import LoraConfig


class ByteTokenizer:
    """The ``--tiny`` model's tokenizer (the JAX CLI's)."""

    def encode(self, t):
        return [1] + [b % 250 + 4 for b in t.encode("utf-8")[:200]]

    def decode(self, ids):
        return bytes((i - 4) % 256 for i in ids if i >= 4).decode("utf-8", "ignore")


def _pairs(path):
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                doc, query = line.rstrip("\n").split("\t", 1)
                yield doc, query


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset_path", type=Path, required=True, help="TSV of document \\t query pairs")
    parser.add_argument("--output_adapter", type=Path, required=True)
    parser.add_argument("--output_merged", type=Path, default=None,
                        help="also save base+adapter merged params")
    parser.add_argument("--llama_path", type=str, default=None, help="local HF Llama checkpoint dir")
    parser.add_argument("--prompt", choices=["en", "vi"], default="en")
    # None = the variant's recipe value (default r=16 alpha=32 lr=2e-4;
    # trl_4bit r=64 alpha=16 lr=2e-4); an explicit flag overrides either
    parser.add_argument("--lora_r", type=int, default=None)
    parser.add_argument("--lora_alpha", type=int, default=None)
    parser.add_argument("--lr", type=float, default=None)
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--max_length", type=int, default=2048)
    parser.add_argument("--total_steps", type=int, default=None)
    parser.add_argument("--enable_profiler", action="store_true")
    parser.add_argument("--tiny", action="store_true", help="tiny random model (smoke)")
    parser.add_argument("--int8_base", action="store_true", help="QLoRA: the frozen base kept int8")
    parser.add_argument("--quantize_base", choices=["none", "int8", "int4"], default=None,
                        help="frozen-base precision on the device; int4 = packed nibbles")
    parser.add_argument("--variant", choices=["default", "trl_4bit"], default="default",
                        help="trl_4bit = the reference's finetune_4bit.py recipe: int4 base, "
                        "LoRA r=64 alpha=16, clip 0.3, weight decay 0.001")
    parser.add_argument("--device", default=None, help="torch device; default cuda (cpu only when asked for)")
    args = parser.parse_args(argv)

    eos_id, pad_id = 2, 0
    if args.tiny:
        from ..models.llama import LlamaConfig, init_llama_params

        config = LlamaConfig.tiny(vocab_size=260)
        params = init_llama_params(config, seed=0)
        tokenizer = ByteTokenizer()
    else:
        if not args.llama_path:
            raise SystemExit("--llama_path required (or --tiny)")
        from ..models.llama import load_hf_llama

        params, config, tokenizer, eos_id = load_hf_llama(args.llama_path)

    quantize_base = args.quantize_base
    if quantize_base == "none":
        quantize_base = None
    elif quantize_base is None and args.int8_base:
        quantize_base = "int8"
    common = dict(
        prompt_template=PROMPT_VI if args.prompt == "vi" else PROMPT_EN,
        max_length=args.max_length,
        eos_token_id=eos_id,
        pad_token_id=pad_id,
        device=args.device,
    )
    if args.variant == "trl_4bit":
        overrides = dict(common)
        if quantize_base is not None:
            overrides["quantize_base"] = quantize_base
        if args.lr is not None:
            overrides["lr"] = args.lr
        if args.lora_r is not None or args.lora_alpha is not None:
            overrides["lora_config"] = LoraConfig(
                r=args.lora_r if args.lora_r is not None else 64,
                alpha=args.lora_alpha if args.lora_alpha is not None else 16,
            )
        ft = Doc2QueryFineTuner.trl_4bit(params, config, tokenizer, **overrides)
    else:
        ft = Doc2QueryFineTuner(
            params, config, tokenizer,
            lora_config=LoraConfig(
                r=args.lora_r if args.lora_r is not None else 16,
                alpha=args.lora_alpha if args.lora_alpha is not None else 32,
            ),
            lr=args.lr if args.lr is not None else 2e-4,
            quantize_base=quantize_base,
            **common,
        )
    del params
    from ..core.profiling import trace

    with trace(args.output_adapter.parent / "profile", enabled=args.enable_profiler):
        avg = ft.train(_pairs(args.dataset_path), batch_size=args.batch_size, total_steps=args.total_steps)
    ft.save_adapter(args.output_adapter)
    print(f"avg loss {avg:.4f}; adapter -> {args.output_adapter}")
    if args.output_merged:
        from ..core.flax_msgpack import write
        from ..models.llama import llama_port_params_to_flax

        write(args.output_merged, llama_port_params_to_flax(ft.merged_params()))
        print(f"merged params -> {args.output_merged}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
