"""Pluggable external word segmenters.

Counterpart of ``improving_learned_index_tpu/text/segmenters.py``.  The
reference's PhoBERT path segments Vietnamese text with VnCoreNLP (a JVM
process; reference src/deep_impact/models/original.py:29-39,129-145) and
normalizes with ``underthesea.text_normalize``.  Any segmenter is a
``Callable[[str], List[str]]`` plugged into the tokenizer stack; the JVM
bridge is optional and constructed lazily.

Deviation: the JAX ``VnCoreNLPSegmenter`` builds its bridge inside the
``try`` that guards segmentation, so a missing ``py_vncorenlp`` gives every
text an empty term list without a word.  Here a missing package (or a bridge
that fails to start) raises; only an error of ``word_segment`` itself falls
back to ``[]`` for that text, as the reference does.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .normalize import normalize, pretokenize


def whitespace_segmenter(text: str) -> List[str]:
    """Default: normalize + whitespace/punctuation split."""
    return pretokenize(normalize(text))


class VnCoreNLPSegmenter:
    """Lazy adapter over py_vncorenlp word segmentation (wseg annotator):
    lowercase + text_normalize, then word segmentation producing
    underscore-joined compound words (reference original.py:135-145)."""

    def __init__(self, save_dir: Optional[str] = None):
        self.save_dir = save_dir
        self._impl = None

    def _get(self):
        if self._impl is None:
            import py_vncorenlp  # gated: requires a JVM and the VnCoreNLP model

            self._impl = py_vncorenlp.VnCoreNLP(
                save_dir=self.save_dir, annotators=["wseg"]
            )
        return self._impl

    def __call__(self, text: str) -> List[str]:
        try:
            from underthesea import text_normalize  # gated
            text = text_normalize(text.lower())
        except ImportError:
            text = text.lower()
        impl = self._get()
        try:
            sents = impl.word_segment(text)
        except Exception:
            sents = []
        return [term for sent in sents for term in sent.split(" ")]


def make_segmenter(kind: str = "whitespace", **kwargs) -> Callable[[str], List[str]]:
    if kind == "whitespace":
        return whitespace_segmenter
    if kind == "vncorenlp":
        return VnCoreNLPSegmenter(**kwargs)
    raise ValueError(f"unknown segmenter kind: {kind}")
