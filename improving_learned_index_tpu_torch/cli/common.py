"""Shared CLI plumbing: tokenizer and model construction from flags.

Counterpart of ``improving_learned_index_tpu/cli/common.py``: the built-in
tokenizer over a WordPiece ``vocab.txt`` (``--vocab_path``) with the
whitespace/punctuation segmenter, and the model kinds ``deepimpact``,
``phobert``, ``xlmr`` (``DeepImpact``), ``pairwise`` (``DeepPairwiseImpact``)
and ``cross_encoder`` (``DeepImpactCrossEncoder``) with random init,
``--tiny`` or ``--hf_name`` (a local directory's ``pytorch_model.bin``), then
``--checkpoint`` (a ``.pt`` file of ``core.checkpoint``: ``DeepImpact.save``
or a ``cli.train`` snapshot such as ``DeepImpact_final.pt``) over them.  A
DeepImpact state dict loads into every kind (the pairwise model then draws
its pair head from the seed).  Not ported yet: ``--hf_tokenizer``,
``--segmenter vncorenlp`` and the JAX package's msgpack checkpoints; each
raises.  ``--device`` picks the torch device (default ``cuda``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..core.config import EncoderConfig
from ..text import ImpactTokenizer, WordPieceVocab

# kind -> (config factory, impact activation); the JAX package's table
MODEL_KINDS = {
    "deepimpact": ("bert_base", "relu"),
    "xlmr": ("xlmr_base", "softplus"),
    "phobert": ("phobert_base", "relu"),
    "pairwise": ("bert_base", "relu"),
    "cross_encoder": ("bert_base", "relu"),
}


def add_tokenizer_args(parser: argparse.ArgumentParser, required: bool = True) -> None:
    parser.add_argument("--vocab_path", type=Path, required=required,
                        help="WordPiece vocab.txt for the built-in tokenizer")
    parser.add_argument("--max_length", type=int, default=None)


def build_tokenizer(args) -> ImpactTokenizer:
    if getattr(args, "hf_tokenizer", None):
        raise NotImplementedError("--hf_tokenizer (text/hf_adapter.py) is not ported yet")
    if getattr(args, "segmenter", "whitespace") != "whitespace":
        raise NotImplementedError("--segmenter vncorenlp is not ported yet")
    if not args.vocab_path:
        raise SystemExit("--vocab_path is required")
    return ImpactTokenizer(WordPieceVocab.load(args.vocab_path), args.max_length or 512)


def add_model_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--model_kind", choices=sorted(MODEL_KINDS), default="deepimpact")
    parser.add_argument("--checkpoint", type=Path, default=None,
                        help="params checkpoint (.pt, core.checkpoint)")
    parser.add_argument("--hf_name", type=str, default=None,
                        help="local HF model directory (pytorch_model.bin) to "
                        "import trunk weights from")
    parser.add_argument("--vocab_path", type=Path, default=None,
                        help="WordPiece vocab.txt for the built-in tokenizer")
    parser.add_argument("--hf_tokenizer", type=str, default=None,
                        help="HF tokenizer id/dir (not ported yet)")
    parser.add_argument("--segmenter", choices=["whitespace", "vncorenlp"],
                        default="whitespace")
    parser.add_argument("--vncorenlp_path", type=Path, default=None)
    parser.add_argument("--max_length", type=int, default=None)
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
        config = EncoderConfig.tiny(vocab_size=len(tokenizer.vocab), impact_activation=activation)
    else:
        config = getattr(EncoderConfig, cfg_factory)()
    state_dict = load_hf_checkpoint(args.hf_name, config) if args.hf_name else None
    if args.checkpoint:
        state_dict = load_params(args.checkpoint)
    return cls(config, tokenizer, state_dict=state_dict, device=args.device)
