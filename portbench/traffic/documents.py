"""Long documents over the passages' words, and the Unigram vocabulary of
an XLM-R-sized tokenizer over them: the text of the XLM-R encode cell.

Documents are drawn as ``traffic/passages.py`` draws passages (the same
50,000-word list, Zipf(1) word ranks, one word in 15 ending a sentence
with a full stop), with lognormal lengths in words around ``median_words``
with spread ``sigma`` (stratified quantiles, clipped to ``min_words`` ..
``max_words``): every seed gets the same multiset of lengths in another
order.

The vocabulary stands in for XLM-R's SentencePiece model, which the
repository does not hold: ``vocab_size`` pieces with XLM-R's special ids
(``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3, ``<mask>`` last), then
``▁`` and every character, alone and word-initial (``▁`` + character),
every syllable of the word list alone and word-initial, the ``whole_words``
most frequent words whole and word-initial, and filler pieces that hold a
``q`` (a letter no word has), as the pieces of XLM-R's other languages are
never met in one language's text.  Scores are Unigram log-probabilities:
a whole word of rank r scores -(2 + ln(r + 1)), a word-initial syllable or
character -13, and a piece that continues a word -14 or less, so a whole
word is always one piece and a rarer word splits at its longest
word-initial piece, then into syllables.  Each score is made distinct by a
small offset, so no two segmentations of a word tie in practice.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from .passages import _CONS, _TAILS, _VOWS, TextSource, _normal_table

SPACE = "▁"  # SentencePiece's word-initial mark
SPECIALS = ["<s>", "<pad>", "</s>", "<unk>"]
MASK = "<mask>"
FILLER = "q"  # in every filler piece, in no word


def vocabulary(words: List[str], size: int, whole_words: int) -> List[Tuple[str, float]]:
    """(piece, score) by id: ``size`` pieces (see the module docstring)."""
    pieces: List[Tuple[str, float]] = [(t, 0.0) for t in SPECIALS]
    seen = set(SPECIALS) | {MASK}

    def add(piece: str, score: float) -> None:
        if piece not in seen:
            seen.add(piece)
            pieces.append((piece, score - 1e-7 * len(pieces)))

    chars = sorted({ch for w in words for ch in w} | {"."})
    syllables = [c + v for c in _CONS for v in _VOWS] + [t for t in _TAILS if t]
    add(SPACE, -13.0)
    for unit in chars + syllables:
        add(SPACE + unit, -13.0)
        add(unit, -14.0)
    for rank, w in enumerate(words[:whole_words]):
        add(SPACE + w, -(2.0 + math.log(rank + 1)))
    rank, digits = whole_words, _CONS + _VOWS
    while len(pieces) < size - 1:
        n, name = len(pieces), FILLER
        while n:
            n, d = divmod(n, len(digits))
            name += digits[d]
        add(SPACE + name, -(2.0 + math.log(rank + 1)))
        rank += 1
    if len(pieces) != size - 1:
        raise ValueError(f"{len(pieces) + 1} pieces, the configuration has {size}")
    pieces.append((MASK, 0.0))
    return pieces


class DocumentSource(TextSource):
    """The words, the vocabulary and the draw of documents of the cell
    (``traffic``: ``words``, ``median_words``, ``sigma``, ``min_words``,
    ``max_words``, ``whole_words``): the passage source's draw, word ranks
    and token counts, with the documents' lengths and the Unigram
    vocabulary."""

    def __init__(self, vocab_size: int, traffic: Dict):
        super().__init__(vocab_size, {"words": traffic["words"], "mean_words": traffic["median_words"]})
        self.sigma = float(traffic["sigma"])
        self.clip = (int(traffic["min_words"]), int(traffic["max_words"]))
        self.vocab = vocabulary(self.words, vocab_size, int(traffic["whole_words"]))

    def lengths(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Stratified lognormal lengths in words around the median
        (``mean_words`` here), shuffled."""
        z = np.interp((np.arange(n) + 0.5) / n, *_normal_table())
        out = np.clip(np.exp(math.log(self.mean_words) + self.sigma * z), *self.clip).astype(int)
        rng.shuffle(out)
        return out

    documents = TextSource.passages
