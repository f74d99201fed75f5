"""Text normalization and pre-tokenization (host side).

Re-implements the normalizer/pre-tokenizer contract the reference gets from
HuggingFace backend tokenizers (reference: src/deep_impact/models/xlmr_original.py:115-118,131-132):
normalize the string, then split into *terms* — the units that carry impact
scores and become inverted-index vocabulary entries.

Self-contained (no network, no external deps) so the framework runs hermetic;
an HF tokenizer can be plugged in via text.hf_adapter when available.
"""

from __future__ import annotations

import re
import string
import unicodedata
from typing import List

PUNCTUATION = set(string.punctuation)

# ASCII fast paths: normalize is a C-speed str.translate, pretokenize a
# compiled regex — the host-side indexing hot loop runs on 1 CPU core
# feeding the chip.  Non-ASCII text takes the general per-char path below.
# Controls (incl. \x0b\x0c, category Cc) drop; \t\n\r become spaces.
_ASCII_NORM = {i: None for i in range(32)}
_ASCII_NORM.update({9: " ", 10: " ", 13: " "})
_ASCII_NORM[127] = None
# words = alnum runs; every other printable non-space char is a standalone
# punctuation term (exactly _is_punct_char's ASCII ranges)
_ASCII_PRETOK = re.compile(r"[0-9a-zA-Z]+|[^\s0-9a-zA-Z]")


def _is_punct_char(ch: str) -> bool:
    cp = ord(ch)
    # ASCII punctuation ranges (as in BERT's BasicTokenizer) + unicode P*.
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def normalize(text: str, lowercase: bool = True, strip_accents: bool = True) -> str:
    """BERT-style cleanup: drop control chars, normalize whitespace,
    optionally lowercase and strip accents (NFD + drop combining marks)."""
    if text.isascii():
        text = text.translate(_ASCII_NORM)
        return text.lower() if lowercase else text  # NFD is identity on ASCII
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if ch.isspace():
            out.append(" ")
        else:
            out.append(ch)
    text = "".join(out)
    if lowercase:
        text = text.lower()
    if strip_accents:
        text = unicodedata.normalize("NFD", text)
        text = "".join(ch for ch in text if unicodedata.category(ch) != "Mn")
    return text


def pretokenize(text: str) -> List[str]:
    """Split normalized text into terms: whitespace-separated words with
    punctuation characters isolated as standalone terms (BertPreTokenizer
    semantics — punctuation terms are later filtered from the impact map)."""
    if text.isascii():
        return _ASCII_PRETOK.findall(text)
    terms: List[str] = []
    buf: List[str] = []
    for ch in text:
        if ch.isspace():
            if buf:
                terms.append("".join(buf))
                buf = []
        elif _is_punct_char(ch):
            if buf:
                terms.append("".join(buf))
                buf = []
            terms.append(ch)
        else:
            buf.append(ch)
    if buf:
        terms.append("".join(buf))
    return terms
