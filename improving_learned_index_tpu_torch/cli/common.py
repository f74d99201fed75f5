"""Shared CLI plumbing: tokenizer construction from flags.

Counterpart of ``improving_learned_index_tpu/cli/common.py`` for the query
path: the built-in tokenizer over a WordPiece ``vocab.txt``
(``--vocab_path``) with the whitespace/punctuation segmenter.  The HF
tokenizer route, the VnCoreNLP segmenter and model construction come with
the encoder slice.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..text import ImpactTokenizer, WordPieceVocab


def add_tokenizer_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--vocab_path", type=Path, required=True,
                        help="WordPiece vocab.txt for the built-in tokenizer")
    parser.add_argument("--max_length", type=int, default=None)


def build_tokenizer(args) -> ImpactTokenizer:
    return ImpactTokenizer(WordPieceVocab.load(args.vocab_path), args.max_length or 512)
