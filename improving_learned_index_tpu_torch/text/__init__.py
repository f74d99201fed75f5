from .normalize import PUNCTUATION, normalize, pretokenize
from .processor import ImpactTokenizer, default_segmenter
from .wordpiece import WordPieceVocab

__all__ = [
    "PUNCTUATION",
    "normalize",
    "pretokenize",
    "ImpactTokenizer",
    "default_segmenter",
    "WordPieceVocab",
]
