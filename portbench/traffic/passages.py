"""Passages of MS MARCO passage shape, their WordPiece vocabulary, and
training triples over them: the general text generator.

Copied in idea from ``chip_smoke.py`` (``make_passages``, phase 6): words
are pronounceable strings drawn Zipf(1) over a fixed list; a passage's
length in words is lognormal around ``mean_words`` (clipped to 5..400);
about one word in 15 ends a sentence with a full stop.  The vocabulary is
every single character, its ``##`` continuation, and the most frequent
whole words, up to the configuration's ``vocab_size`` (rare words then
split into pieces, as a real vocabulary splits them).

The word list and the vocabulary depend on the configuration alone, as a
deployed ``vocab.txt`` does; the seed picks the passages.  Every seed gets
the same multiset of passage lengths (stratified lognormal quantiles) in
another order, and stratified word ranks, so two seeds do the same work.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

SPECIAL_TOKENS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
_CONS, _VOWS, _TAILS = "bcdfghjklmnprstvwz", "aeiouy", ("", "s", "n", "r")
WORD_LIST_SEED = 20240517  # the word list is part of the configuration


@functools.lru_cache(maxsize=1)
def _normal_table(points: int = 20001):
    """The standard normal's quantiles at (i + 1/2)/points."""
    from statistics import NormalDist

    u = (np.arange(points) + 0.5) / points
    return u, np.array([NormalDist().inv_cdf(x) for x in u])


def word_list(n_words: int) -> List[str]:
    """``n_words`` distinct words of 2-5 syllables, by frequency rank."""
    rng = np.random.default_rng(WORD_LIST_SEED)
    words, seen = [], set()
    while len(words) < n_words:
        m = 2 * n_words
        syl = rng.integers(2, 6, m)
        c, v, t = rng.integers(0, 18, (m, 5)), rng.integers(0, 6, (m, 5)), rng.integers(0, 4, m)
        for i in range(m):
            w = "".join(_CONS[c[i, j]] + _VOWS[v[i, j]] for j in range(syl[i])) + _TAILS[t[i]]
            if w not in seen and len(words) < n_words:
                seen.add(w)
                words.append(w)
    return words


def vocab_tokens(words: List[str], size: int) -> List[str]:
    """Specials, characters and continuations, then whole words by rank."""
    chars = sorted({ch for w in words for ch in w} | {"."})
    tokens = SPECIAL_TOKENS + chars + [f"##{ch}" for ch in chars]
    seen = set(tokens)
    for w in words:
        if len(tokens) >= size:
            break
        if w not in seen and len(w) > 1:
            tokens.append(w)
            seen.add(w)
    return tokens


class TextSource:
    """The words, the vocabulary and the draw of passages of one text
    configuration (``traffic`` parameters: ``words``, ``mean_words``)."""

    def __init__(self, vocab_size: int, traffic: Dict):
        self.n_words = int(traffic["words"])
        self.mean_words = float(traffic["mean_words"])
        self.words = word_list(self.n_words)
        self.vocab = vocab_tokens(self.words, vocab_size)
        cdf = np.cumsum(1.0 / np.arange(1, self.n_words + 1))
        self._cdf = cdf / cdf[-1]
        # each word with and without a full stop: token strings by id
        self._tokens = np.array(self.words + [w + "." for w in self.words], dtype=object)

    def word_ids(self, n: int, rng: np.random.Generator) -> np.ndarray:
        u = (np.arange(n) + rng.random(n)) / n
        ids = np.minimum(np.searchsorted(self._cdf, u, side="right"), self.n_words - 1)
        rng.shuffle(ids)
        return ids

    def lengths(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Stratified lognormal lengths in words, shuffled."""
        z = np.interp((np.arange(n) + 0.5) / n, *_normal_table())
        out = np.clip(np.exp(np.log(self.mean_words) - 0.18 + 0.6 * z), 5, 400).astype(int)
        rng.shuffle(out)
        return out

    def draw(self, n: int, seed: int, stream: int = 0):
        """``n`` passages from ``(seed, stream)``: (texts, word ids, full
        stops, lengths in words)."""
        rng = np.random.default_rng([int(seed), 2, stream])
        lengths = self.lengths(n, rng)
        ids = self.word_ids(int(lengths.sum()), rng)
        ends = rng.random(len(ids)) < 1 / 15
        # tokens and separators interleaved, one join, split at passage ends
        text = np.empty(2 * len(ids), dtype=object)
        text[0::2] = self._tokens[ids + self.n_words * ends]
        text[1::2] = " "
        text[2 * np.cumsum(lengths) - 1] = "\n"
        return "".join(text.tolist()).split("\n")[:n], ids, ends, lengths

    def passages(self, n: int, seed: int, stream: int = 0) -> List[str]:
        return self.draw(n, seed, stream)[0]

    def token_counts(self, ids: np.ndarray, ends: np.ndarray, lengths: np.ndarray, pieces: np.ndarray,
                     max_length: int) -> np.ndarray:
        """Tokens of each drawn passage: [CLS], each word's pieces
        (``pieces[word id]``) and its full stop, [SEP], at most
        ``max_length``."""
        per_word = pieces[ids] + ends
        bounds = np.zeros(len(lengths) + 1, np.int64)
        np.cumsum(lengths, out=bounds[1:])
        sums = np.add.reduceat(per_word, bounds[:-1]) if len(per_word) else np.zeros(len(lengths), np.int64)
        return np.minimum(sums + 2, max_length)


def make_triples(passages: List[str], n: int, traffic: Dict, seed: int) -> Tuple[List[str], List[Tuple[int, int, int]]]:
    """``n`` triples over ``passages`` (at least ``2 n``): query i is
    ``query_words`` (stratified, shuffled) distinct words of passage i, its
    positive; its negative is passage ``n + i``.  Every document of every
    triple differs.  Returns (query texts, (qid, pos pid, neg pid))."""
    if len(passages) < 2 * n:
        raise ValueError(f"{n} triples need {2 * n} passages")
    rng = np.random.default_rng([int(seed), 3])
    lo, hi = traffic["query_words"]
    counts = np.resize(np.arange(lo, hi + 1), n)
    rng.shuffle(counts)
    queries = []
    for i in range(n):
        words = list(dict.fromkeys(w.rstrip(".") for w in passages[i].split()))
        pick = rng.choice(len(words), size=min(int(counts[i]), len(words)), replace=False)
        queries.append(" ".join(words[j] for j in sorted(pick)))
    return queries, [(i, i, n + i) for i in range(n)]
