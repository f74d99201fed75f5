"""Self-contained WordPiece subword tokenizer.

The port's copy of ``improving_learned_index_tpu/text/wordpiece.py``:
greedy longest-match-first with ``##`` continuation pieces -- the same
algorithm as BERT's WordPiece, so a ``vocab.txt`` from any BERT-family
checkpoint drops in directly -- and corpus-driven vocabulary construction
for hermetic tests and zero-network environments.
"""

from __future__ import annotations

from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Union

from .normalize import normalize, pretokenize

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = [PAD, UNK, CLS, SEP, MASK]


class WordPieceVocab:
    def __init__(self, tokens: List[str]):
        self.id_to_token = list(tokens)
        self.token_to_id: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        for tok in SPECIAL_TOKENS:
            if tok not in self.token_to_id:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = self.token_to_id[PAD]
        self.unk_id = self.token_to_id[UNK]
        self.cls_id = self.token_to_id[CLS]
        self.sep_id = self.token_to_id[SEP]

    def __len__(self) -> int:
        return len(self.id_to_token)

    def save(self, path: Union[str, Path]) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for tok in self.id_to_token:
                f.write(tok + "\n")

    @classmethod
    def load(cls, path: Union[str, Path]) -> "WordPieceVocab":
        with open(path, encoding="utf-8") as f:
            return cls([line.rstrip("\n") for line in f if line.rstrip("\n")])

    @classmethod
    def build(
        cls,
        texts: Iterable[str],
        max_size: int = 8192,
        min_freq: int = 1,
        lowercase: bool = True,
    ) -> "WordPieceVocab":
        """Build a vocabulary: all single characters + frequent whole words.

        Whole words that fit the budget become single tokens; everything else
        decomposes to characters (guaranteeing no UNK for seen characters).
        Texts are counted in joined chunks of 1000: ``normalize`` maps the
        ``\\n`` joiners to spaces, so a chunk yields exactly the concatenation
        of the per-text term streams at a fraction of the per-text cost.
        """
        word_counts: Counter = Counter()
        chunk = 1000
        batch: list = []
        for text in texts:
            batch.append(text)
            if len(batch) == chunk:
                word_counts.update(pretokenize(normalize("\n".join(batch), lowercase=lowercase)))
                batch = []
        if batch:
            word_counts.update(pretokenize(normalize("\n".join(batch), lowercase=lowercase)))
        char_set = set()
        for term in word_counts:
            char_set.add(term[0])
            for ch in term[1:]:
                char_set.add(f"##{ch}")
        tokens = list(SPECIAL_TOKENS)
        tokens.extend(sorted(char_set))
        seen = set(tokens)
        for word, cnt in word_counts.most_common():
            if len(tokens) >= max_size:
                break
            if cnt < min_freq or word in seen or len(word) <= 1:
                continue
            tokens.append(word)
            seen.add(word)
        return cls(tokens)


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a fixed vocab, with a word cache
    (corpora are Zipf, so it hits most of the time: this is the host-side
    hot loop of the encode path)."""

    _CACHE_MAX = 1 << 20

    def __init__(self, vocab: WordPieceVocab, max_chars_per_word: int = 100):
        self.vocab = vocab
        self.max_chars_per_word = max_chars_per_word
        self._cache: Dict[str, List[int]] = {}

    def tokenize_word(self, word: str) -> List[int]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        ids = self._tokenize_word_uncached(word)
        if len(self._cache) < self._CACHE_MAX:
            self._cache[word] = ids
        return ids

    def _tokenize_word_uncached(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.vocab.unk_id]
        ids: List[int] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                tid = self.vocab.token_to_id.get(piece)
                if tid is not None:
                    cur = tid
                    break
                end -= 1
            if cur is None:
                return [self.vocab.unk_id]
            ids.append(cur)
            start = end
        return ids
