"""Shared CLI plumbing: tokenizer and model construction from flags.

Counterpart of ``improving_learned_index_tpu/cli/common.py``: the built-in
tokenizer over a WordPiece ``vocab.txt`` (``--vocab_path``) or a local
HuggingFace fast tokenizer directory (``--hf_tokenizer``, through
``text.hf_adapter``; it needs ``transformers`` and raises ``ImportError``
without it), either with the whitespace/punctuation segmenter or
``--segmenter vncorenlp`` (``text.segmenters``; it needs ``py_vncorenlp``
and raises ``ImportError`` at the first text without it), and the model
kinds ``deepimpact``, ``phobert``, ``xlmr`` (``DeepImpact``), ``pairwise``
(``DeepPairwiseImpact``) and ``cross_encoder`` (``DeepImpactCrossEncoder``)
with random init, ``--tiny`` or ``--hf_name`` (a local directory's
``pytorch_model.bin``), then ``--checkpoint`` over them: a ``.pt`` file of
``core.checkpoint`` (``DeepImpact.save`` or a ``cli.train`` snapshot such as
``DeepImpact_final.pt``) or a JAX package ``.msgpack`` (its ``save_params``
or a ``CheckpointManager`` snapshot, read by ``core.flax_msgpack``).  A
DeepImpact state dict loads into every kind (the pairwise model then draws
its pair head from the seed).  ``--device`` picks the torch device (default
``cuda``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..core.config import EncoderConfig
from ..text import ImpactTokenizer, WordPieceVocab, make_segmenter

# kind -> (config factory, impact activation); the JAX package's table
MODEL_KINDS = {
    "deepimpact": ("bert_base", "relu"),
    "xlmr": ("xlmr_base", "softplus"),
    "phobert": ("phobert_base", "relu"),
    "pairwise": ("bert_base", "relu"),
    "cross_encoder": ("bert_base", "relu"),
}


def add_tokenizer_args(parser: argparse.ArgumentParser) -> None:
    """The tokenizer flags (one of ``--vocab_path`` or ``--hf_tokenizer``)."""
    parser.add_argument("--vocab_path", type=Path, default=None,
                        help="WordPiece vocab.txt for the built-in tokenizer")
    parser.add_argument("--hf_tokenizer", type=str, default=None,
                        help="local HF fast tokenizer directory (uses text.hf_adapter; "
                        "needs transformers)")
    parser.add_argument("--segmenter", choices=["whitespace", "vncorenlp"],
                        default="whitespace")
    parser.add_argument("--vncorenlp_path", type=Path, default=None,
                        help="VnCoreNLP model directory (--segmenter vncorenlp)")
    parser.add_argument("--max_length", type=int, default=None)


def _vncorenlp(args):
    return make_segmenter(
        "vncorenlp", save_dir=str(args.vncorenlp_path) if args.vncorenlp_path else None
    )


def build_tokenizer(args):
    max_length = args.max_length or 512
    if args.hf_tokenizer:
        from ..text.hf_adapter import load_hf_tokenizer

        tok = load_hf_tokenizer(args.hf_tokenizer, max_length)
        if args.segmenter == "vncorenlp":
            tok._segmenter = _vncorenlp(args)
        return tok
    if not args.vocab_path:
        raise SystemExit("--vocab_path or --hf_tokenizer is required")
    segmenter = _vncorenlp(args) if args.segmenter == "vncorenlp" else None
    return ImpactTokenizer(WordPieceVocab.load(args.vocab_path), max_length, segmenter=segmenter)


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model_kind", choices=sorted(MODEL_KINDS), default="deepimpact")
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="params checkpoint: .pt (core.checkpoint) or the JAX "
                        "package's .msgpack")
    parser.add_argument("--hf_name", type=str, default=None,
                        help="local HF model directory (pytorch_model.bin) to "
                        "import trunk weights from")
    add_tokenizer_args(parser)
    parser.add_argument("--tiny", action="store_true",
                        help="tiny random model (tests/smoke)")
    parser.add_argument("--device", default=None,
                        help="torch device; default cuda (cpu only when asked for)")


def build_model(args):
    from ..core.checkpoint import load_params
    from ..models import DeepImpact, DeepImpactCrossEncoder, DeepPairwiseImpact
    from ..models.hf_import import load_hf_checkpoint

    tokenizer = build_tokenizer(args)
    cfg_factory, activation = MODEL_KINDS[args.model_kind]
    cls = {"pairwise": DeepPairwiseImpact, "cross_encoder": DeepImpactCrossEncoder}.get(
        args.model_kind, DeepImpact
    )
    if args.tiny:
        vocab_size = len(tokenizer.vocab) if hasattr(tokenizer, "vocab") else 512
        config = EncoderConfig.tiny(vocab_size=vocab_size, impact_activation=activation)
    else:
        config = getattr(EncoderConfig, cfg_factory)()
    state_dict = load_hf_checkpoint(args.hf_name, config) if args.hf_name else None
    if args.checkpoint:
        state_dict = load_params(args.checkpoint, config)
    return cls(config, tokenizer, state_dict=state_dict, device=args.device)
