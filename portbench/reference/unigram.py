"""Plain XLM-R-style text processing over a Unigram vocabulary: the
reference's own, written from the semantics and importing nothing of the
program or of ``tokenizers``.

- A term is a run of non-space characters with ``▁`` before it (the
  Metaspace pre-tokenizer: text split at spaces, each word marked as
  word-initial).
- A word's pieces are the segmentation of its term with the highest sum of
  piece scores (Viterbi), ties kept by the first found: start positions in
  order, and at each start the pieces in order of length, a later
  candidate taking a position only with a strictly higher score.  A
  character that begins no piece becomes ``<unk>``, scored 10 below the
  lowest piece.
- A document is ``<s>``, the pieces of its terms, truncated so that
  ``</s>`` still fits in ``max_length``.  Each distinct term that is not
  punctuation maps to the position of its first piece at its first
  occurrence; a term cut off by the truncation maps nowhere.
"""

from __future__ import annotations

import string
from typing import Dict, List, Sequence, Tuple

PUNCTUATION = set(string.punctuation)
SPACE = "▁"


class UnigramTokenizer:
    def __init__(self, vocab: Sequence[Tuple[str, float]]):
        self.ids = {p: i for i, (p, _) in enumerate(vocab)}
        self.scores = [s for _, s in vocab]
        self.longest = max(len(p) for p, _ in vocab)
        self.unk_score = min(self.scores) - 10.0
        self.bos, self.pad, self.eos, self.unk = (self.ids[t] for t in ("<s>", "<pad>", "</s>", "<unk>"))
        self._cache: Dict[str, List[int]] = {}

    @staticmethod
    def terms(text: str) -> List[str]:
        return [SPACE + w for w in text.split()]

    def pieces(self, term: str) -> List[int]:
        got = self._cache.get(term)
        if got is not None:
            return got
        n = len(term)
        best: List[Tuple[float, int, int] | None] = [None] * (n + 1)  # (score, start, id)
        best[0] = (0.0, -1, -1)
        for start in range(n):
            if best[start] is None:
                continue
            here = best[start][0]
            single = False
            for end in range(start + 1, min(n, start + self.longest) + 1):
                i = self.ids.get(term[start:end])
                if i is None:
                    continue
                single = single or end == start + 1
                cand = here + self.scores[i]
                if best[end] is None or cand > best[end][0]:
                    best[end] = (cand, start, i)
            if not single:
                cand = here + self.unk_score
                if best[start + 1] is None or cand > best[start + 1][0]:
                    best[start + 1] = (cand, start, self.unk)
        out, at = [], n
        while at > 0:
            _, start, i = best[at]
            out.append(i)
            at = start
        out.reverse()
        self._cache[term] = out
        return out

    def document(self, text: str, max_length: int) -> Tuple[List[int], Dict[str, int]]:
        """(token ids, unpadded; term -> position of its first piece)."""
        ids = [self.bos]
        first: Dict[str, int] = {}
        for term in self.terms(text):
            if len(ids) >= max_length - 1:
                break
            at = len(ids)
            ids.extend(self.pieces(term)[: max_length - 1 - at])
            if term not in PUNCTUATION and term not in first:
                first[term] = at
        ids.append(self.eos)
        return ids, first
