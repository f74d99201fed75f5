"""WordPiece vocabulary file handling.

The port's copy of ``WordPieceVocab`` from
``improving_learned_index_tpu/text/wordpiece.py``: a ``vocab.txt`` from any
BERT-family checkpoint loads directly.  The query path needs the vocabulary
only; the subword tokenizer and corpus-driven vocabulary construction come
with the encoder slice.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

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
