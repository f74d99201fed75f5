"""Normalize + segment + stopword-filter a collection
(reference scripts/preprocess_passages.py:14-21,56-72: text normalization,
word segmentation, stopword removal with a negation whitelist that keeps
negated compounds intact).

The port's copy of
``improving_learned_index_tpu/scripts/preprocess_passages.py``, host only:
``python -m improving_learned_index_tpu_torch.scripts.preprocess_passages``.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Set, Union

from ..data.datasets import stream_collection
from ..text.segmenters import make_segmenter

DEFAULT_NEGATION_WHITELIST = {"không", "chưa", "chẳng", "not", "no", "never"}


def preprocess_text(
    text: str,
    segmenter,
    stopwords: Set[str],
    negation_whitelist: Set[str] = frozenset(DEFAULT_NEGATION_WHITELIST),
) -> str:
    terms = segmenter(text)
    kept: List[str] = []
    for t in terms:
        if t in stopwords and t not in negation_whitelist:
            continue
        kept.append(t)
    return " ".join(kept)


def preprocess_collection(
    collection_path: Union[str, Path],
    output_path: Union[str, Path],
    stopwords_path: Optional[Union[str, Path]] = None,
    segmenter_kind: str = "whitespace",
    collection_type: str = "msmarco",
    resume: bool = True,
    **segmenter_kwargs,
) -> int:
    """Resumable (skiprows from output line count, reference
    llama2/evaluation/preprocess.py:87-92)."""
    stopwords: Set[str] = set()
    if stopwords_path:
        with open(stopwords_path, encoding="utf-8") as f:
            stopwords = {line.strip() for line in f if line.strip()}
    segmenter = make_segmenter(segmenter_kind, **segmenter_kwargs)

    skip = 0
    out_path = Path(output_path)
    if resume and out_path.exists():
        with open(out_path, encoding="utf-8") as f:
            skip = sum(1 for _ in f)

    n = 0
    with open(out_path, "a", encoding="utf-8") as out:
        for i, (pid, text) in enumerate(
            stream_collection(collection_path, collection_type)
        ):
            if i < skip:
                continue
            out.write(f"{pid}\t{preprocess_text(text, segmenter, stopwords)}\n")
            n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--output_path", type=Path, required=True)
    parser.add_argument("--stopwords_path", type=Path, default=None)
    parser.add_argument("--segmenter", default="whitespace", choices=["whitespace", "vncorenlp"])
    parser.add_argument("--collection_type", default="msmarco")
    parser.add_argument("--no_resume", action="store_true")
    args = parser.parse_args(argv)
    n = preprocess_collection(
        args.collection_path,
        args.output_path,
        args.stopwords_path,
        args.segmenter,
        args.collection_type,
        resume=not args.no_resume,
    )
    print(f"preprocessed {n} new passages -> {args.output_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
