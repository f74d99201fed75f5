from .normalize import PUNCTUATION, normalize, pretokenize
from .packing import PackedBatch, SequencePacker, pack_documents
from .processor import (
    DocumentEncoding,
    ImpactTokenizer,
    batch_arrays,
    batch_term_slots,
    default_segmenter,
)
from .segmenters import VnCoreNLPSegmenter, make_segmenter, whitespace_segmenter
from .wordpiece import WordPieceTokenizer, WordPieceVocab

__all__ = [
    "PUNCTUATION",
    "normalize",
    "pretokenize",
    "PackedBatch",
    "SequencePacker",
    "pack_documents",
    "DocumentEncoding",
    "ImpactTokenizer",
    "batch_arrays",
    "batch_term_slots",
    "default_segmenter",
    "WordPieceTokenizer",
    "WordPieceVocab",
    "VnCoreNLPSegmenter",
    "make_segmenter",
    "whitespace_segmenter",
]
