"""Host query engine over the binary inverted-index format.

The port's copy of ``improving_learned_index_tpu/search/engine.py``: numpy
only, host code in both packages, so it takes no ``device``.

Format- and semantics-parity with the reference query path
(src/deep_impact/inverted_index/inverted_index.py:19-62): look up each query
term's postings, stop at a zero impact, accumulate per-doc sums, return the
top-k by score.  Vectorized with numpy instead of the reference's per-record
struct.unpack loop; the C++ native engine (search.native) and the card's
engines share this interface.
"""

from __future__ import annotations

import heapq
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Set, Tuple, Union

import numpy as np

from ..index.inverted import InvertedIndexData

PathLike = Union[str, Path]


class InvertedIndex:
    """Query-time scoring over CSR postings (load from the binary format)."""

    def __init__(self, index: InvertedIndexData):
        self.index = index

    @classmethod
    def load(cls, index_path: PathLike) -> "InvertedIndex":
        return cls(InvertedIndexData.load(index_path))

    def term_docs(self, term: str) -> List[Tuple[int, int]]:
        """Postings as (doc_id, impact), truncated at the first zero impact
        (reference inverted_index.py:41-53)."""
        docs, impacts = self.index.term_postings(term)
        nz = np.flatnonzero(impacts == 0)
        if len(nz):
            docs, impacts = docs[: nz[0]], impacts[: nz[0]]
        return list(zip(docs.tolist(), impacts.tolist()))

    def score(self, query_terms: Iterable[str], top_k: int = 1000) -> List[Tuple[int, float]]:
        scores: Dict[int, float] = {}
        for term in query_terms:
            docs, impacts = self.index.term_postings(term)
            for d, v in zip(docs.tolist(), impacts.tolist()):
                if v == 0:
                    break
                scores[d] = scores.get(d, 0) + v
        return heapq.nlargest(top_k, scores.items(), key=lambda x: x[1])

    def score_batch(
        self, query_term_sets: Sequence[Set[str]], top_k: int = 1000
    ) -> List[List[Tuple[int, float]]]:
        """Vectorized accumulation: per query, one bincount over the gathered
        postings instead of a Python dict loop."""
        out = []
        num_docs = self.index.num_docs
        for terms in query_term_sets:
            tids = [self.index.term_to_id[t] for t in terms if t in self.index.term_to_id]
            if not tids:
                out.append([])
                continue
            segs_d = []
            segs_v = []
            for tid in tids:
                s, e = self.index.offsets[tid], self.index.offsets[tid + 1]
                segs_d.append(self.index.doc_ids[s:e])
                segs_v.append(self.index.impacts[s:e])
            docs = np.concatenate(segs_d).astype(np.int64)
            vals = np.concatenate(segs_v).astype(np.float64)
            acc = np.bincount(docs, weights=vals, minlength=num_docs)
            k = min(top_k, int(np.count_nonzero(acc)))
            if k == 0:
                out.append([])
                continue
            # deterministic ordering: score desc, doc id asc — matches the
            # card's engines and the native engine's tie-break
            nz = np.flatnonzero(acc)
            order = np.lexsort((nz, -acc[nz]))[:k]
            idx = nz[order]
            out.append([(int(i), float(acc[i])) for i in idx])
        return out
