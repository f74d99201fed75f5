"""MaxP long-document support: sliding-window passaging + max-score
aggregation.

The port's copy of ``improving_learned_index_tpu/search/maxp.py`` (host
code, no device).

Capability parity with the reference MaxP pipeline
(src/deep_impact/scripts/create_passages.py:9-23,109-127 and
src/deep_impact/aggregate_run.py:5-58): long documents split into
word-windows (250 words, stride 100 by default), each passage indexed with
an integer pid mapped back via ``pid_mapping.txt`` (entries ``doc_id#i``),
then per-document max over passage scores after ranking.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple, Union

PathLike = Union[str, Path]

WINDOW = 250
STRIDE = 100


def make_passages(
    text: str, window: int = WINDOW, stride: int = STRIDE
) -> List[str]:
    """Word-level sliding windows; always at least one passage."""
    words = text.split()
    if len(words) <= window:
        return [" ".join(words)]
    passages = []
    start = 0
    while start < len(words):
        chunk = words[start : start + window]
        passages.append(" ".join(chunk))
        if start + window >= len(words):
            break
        start += stride
    return passages


def passage_collection(
    docs: Iterable[Tuple[str, str]],
    expansion_per_doc: Optional[Dict[str, str]] = None,
    window: int = WINDOW,
    stride: int = STRIDE,
) -> Iterator[Tuple[int, str, str]]:
    """Yield (int_pid, "doc_id#i", passage_text); document-level expansion
    text is appended to every window (reference create_passages.py:112-117).
    """
    pid = 0
    for doc_id, text in docs:
        expansion = (expansion_per_doc or {}).get(doc_id, "")
        for i, passage in enumerate(make_passages(text, window, stride)):
            if expansion:
                passage = f"{passage} {expansion}"
            yield pid, f"{doc_id}#{i}", passage
            pid += 1


def write_passage_files(
    docs: Iterable[Tuple[str, str]],
    collection_out: PathLike,
    mapping_out: PathLike,
    expansion_per_doc: Optional[Dict[str, str]] = None,
    window: int = WINDOW,
    stride: int = STRIDE,
) -> int:
    n = 0
    with open(collection_out, "w", encoding="utf-8") as cf, open(
        mapping_out, "w", encoding="utf-8"
    ) as mf:
        for pid, mapped_id, passage in passage_collection(
            docs, expansion_per_doc, window, stride
        ):
            cf.write(f"{pid}\t{passage}\n")
            mf.write(mapped_id + "\n")
            n += 1
    return n


def aggregate_run(
    run_file: PathLike,
    mapping_file: PathLike,
    output: PathLike,
    top_k: int = 1000,
) -> int:
    """MaxP aggregation: passage run -> document run keeping the max passage
    score per document (reference aggregate_run.py:16-58)."""
    index_to_real: Dict[str, str] = {}
    with open(mapping_file, encoding="utf-8") as f:
        for idx, line in enumerate(f):
            index_to_real[str(idx)] = line.strip()

    results: Dict[str, Dict[str, float]] = defaultdict(dict)
    with open(run_file, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 4:
                continue
            qid, int_pid, score = parts[0], parts[1], float(parts[3])
            real_pid = index_to_real.get(int_pid)
            if real_pid is None:
                continue
            doc_id = real_pid.split("#")[0] if "#" in real_pid else real_pid
            if score > results[qid].get(doc_id, float("-inf")):
                results[qid][doc_id] = score

    n = 0
    with open(output, "w", encoding="utf-8") as f:
        for qid in sorted(results, key=lambda x: int(x) if x.isdigit() else x):
            ranked = sorted(results[qid].items(), key=lambda x: x[1], reverse=True)[:top_k]
            for rank, (doc_id, score) in enumerate(ranked, start=1):
                f.write(f"{qid}\t{doc_id}\t{rank}\t{score:.6f}\n")
                n += 1
    return n
