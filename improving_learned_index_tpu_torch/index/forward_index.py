"""Forward index ("term: score, term: score" lines, one document per line,
implicit doc id = line number) -- format parity with the reference
(src/deep_impact/index.py:62-68, indexing/deep_impact_collection.py:6-33).

The port's copy of ``improving_learned_index_tpu/index/forward_index.py``
(pure Python).  ``PairwiseForwardIndex`` reads back the ``term1|term2``
composite entries that the pairwise model writes (``models/pairwise.py``).
"""

from __future__ import annotations

from itertools import permutations
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Set, Tuple, Union

from ..ops.quantize import quantize_value

PathLike = Union[str, Path]


def format_line(term_impacts: Sequence[Tuple[str, float]], decimals: int = 3) -> str:
    """Reference rounds impacts to 3 decimals when writing (indexer.py:64)."""
    return ", ".join(f"{term}: {round(float(impact), decimals)}" for term, impact in term_impacts)


def format_quantized_line(term_impacts: Sequence[Tuple[str, int]]) -> str:
    return ", ".join(f"{term}: {int(impact)}" for term, impact in term_impacts)


def parse_line(line: str) -> Dict[str, float]:
    line = line.strip()
    if not line:
        return {}
    out: Dict[str, float] = {}
    for pair in line.split(", "):
        term, score = pair.split(": ")
        out[term] = float(score)
    return out


class ForwardIndex:
    """In-memory forward index (reference DeepImpactCollection)."""

    def __init__(self, index_path: PathLike):
        with open(index_path, encoding="utf-8") as f:
            self.lines: List[str] = [line.rstrip("\n") for line in f]

    def __len__(self) -> int:
        return len(self.lines)

    def __getitem__(self, pid: int) -> Dict[str, float]:
        return parse_line(self.lines[pid])

    def __iter__(self) -> Iterator[Tuple[int, Dict[str, float]]]:
        for pid in range(len(self)):
            yield pid, self[pid]

    def score(self, pid: int, query_terms: Set[str]) -> float:
        impacts = self[pid]
        return sum(impacts.get(t, 0) for t in query_terms)


class PairwiseForwardIndex(ForwardIndex):
    """Adds term1|term2 composite postings (reference deep_impact_collection.py:36-45).

    Single terms are summed first, then every ordered pair of distinct query
    terms in ``permutations`` order, so one set gives the JAX class's float.
    """

    def score(self, pid: int, query_terms: Set[str]) -> float:
        total = super().score(pid, query_terms)
        impacts = self[pid]
        for t1, t2 in permutations(query_terms, 2):
            total += impacts.get(f"{t1}|{t2}", 0)
        return total


def iter_forward_index(index_path: PathLike) -> Iterator[Tuple[int, Dict[str, float]]]:
    """Stream the forward index without materializing it."""
    with open(index_path, encoding="utf-8") as f:
        for pid, line in enumerate(f):
            yield pid, parse_line(line)


def quantize_file(
    input_file_path: PathLike,
    output_file_path: PathLike,
    max_val: float = None,
    bits: int = 8,
) -> float:
    """2-pass file quantization with exact reference parity
    (indexing/quantize.py:27-47): find global max, scale, truncate,
    drop zero-quantized terms."""
    if max_val is None:
        max_val = 0.0
        with open(input_file_path, encoding="utf-8") as f:
            for line in f:
                for term, score in parse_line(line).items():
                    max_val = max(max_val, score)
        # empty or all-zero forward index: any positive scale works — every
        # impact quantizes to 0 and drops (quantize_store guards identically)
        max_val = max_val or 1.0
    scale = ((1 << bits) - 1) / max_val
    with open(input_file_path, encoding="utf-8") as f, open(
        output_file_path, "w", encoding="utf-8"
    ) as out:
        for line in f:
            data = []
            for term, score in parse_line(line).items():
                val = quantize_value(score, scale)
                if val > 0:
                    data.append(f"{term}: {val}")
            out.write(", ".join(data) + "\n")
    return max_val
