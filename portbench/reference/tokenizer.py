"""Plain BERT-style text processing for ASCII text: the reference's own,
written from the semantics and importing nothing of the program.

- A term is a run of ASCII letters and digits, or any other single
  non-space character; text is lowercased, control characters other than
  tab and newlines dropped.
- A query is the set of its terms less punctuation.
- A document is ``[CLS]``, the WordPiece pieces of its terms (greedy
  longest match first, ``##`` continuations, a word of more than 100
  characters or with no match is ``[UNK]``), truncated so that ``[SEP]``
  still fits in ``max_length``.  Each distinct non-punctuation term maps to
  the position of its first piece at its first occurrence; a term cut off
  by the truncation maps nowhere.
"""

from __future__ import annotations

import re
import string
from typing import Dict, List, Set, Tuple

PUNCTUATION = set(string.punctuation)
_TERM = re.compile(r"[0-9a-z]+|[^\s0-9a-z]")


class Tokenizer:
    def __init__(self, vocab: List[str]):
        self.ids = {t: i for i, t in enumerate(vocab)}
        self.cls, self.sep, self.unk, self.pad = (self.ids[t] for t in ("[CLS]", "[SEP]", "[UNK]", "[PAD]"))
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def terms(text: str) -> List[str]:
        if not text.isascii():
            raise ValueError("the reference tokenizer reads ASCII text only")
        clean = "".join(" " if ch in "\t\n\r" else ch for ch in text if ord(ch) >= 32 and ord(ch) != 127)
        return _TERM.findall(clean.lower())

    def query(self, text: str) -> Set[str]:
        return {t for t in self.terms(text) if t not in PUNCTUATION}

    def pieces(self, word: str) -> List[int]:
        got = self._cache.get(word)
        if got is not None:
            return got
        out: List[int] = []
        start = 0
        while start < len(word):
            if len(word) > 100:
                out = [self.unk]
                break
            for end in range(len(word), start, -1):
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.ids:
                    out.append(self.ids[piece])
                    start = end
                    break
            else:
                out = [self.unk]
                break
        self._cache[word] = out
        return out

    def document(self, text: str, max_length: int) -> Tuple[List[int], Dict[str, int]]:
        """(token ids, unpadded; term -> position of its first piece)."""
        ids = [self.cls]
        first: Dict[str, int] = {}
        for term in self.terms(text):
            if len(ids) >= max_length - 1:
                break
            at = len(ids)
            ids.extend(self.pieces(term)[: max_length - 1 - at])
            if term not in PUNCTUATION and term not in first:
                first[term] = at
        ids.append(self.sep)
        return ids, first
