"""Exact top-k over a quantized impact index: the reference of the query
cells.

A query's score for a doc is the sum of the impacts of the query's terms
in that doc; the answer is the k highest positive scores, ties in doc-id
order (the lower id first).  Plain PyTorch on any device, from the raw
postings the benchmark made; it imports nothing of the program.

``impact_bits=4`` is the control: each 8-bit impact cut to its top four
bits (and put back at the middle of its 4-bit step), the precision below
the configuration's.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_DOC_BITS = 24  # doc ids below 2**24: a (score, -doc) key fits an int64


class Scorer:
    def __init__(self, offsets, docs, vals, num_docs: int, device, impact_bits: int = 8):
        if num_docs >= 1 << _DOC_BITS:
            raise ValueError("the reference scorer keys doc ids in 24 bits")
        self.offsets = [int(x) for x in offsets]
        self.num_docs = num_docs
        self.device = device
        self.docs = torch.from_numpy(docs.view("int32")).to(device).long()
        v = torch.from_numpy(vals).to(device).to(torch.int64)
        if impact_bits == 4:
            v = ((v >> 4) << 4) + 8
        elif impact_bits != 8:
            raise ValueError("impact_bits is 8 or 4")
        self.vals = v

    def topk(self, term_ids: Sequence[int], k: int) -> List[Tuple[int, int]]:
        scores = torch.zeros(self.num_docs, dtype=torch.int64, device=self.device)
        for t in set(term_ids):
            s, e = self.offsets[t], self.offsets[t + 1]
            scores.index_add_(0, self.docs[s:e], self.vals[s:e])
        low = (1 << _DOC_BITS) - 1
        key = scores * (1 << _DOC_BITS) + (low - torch.arange(self.num_docs, device=self.device))
        top = torch.topk(key, min(k, self.num_docs)).values.cpu()
        out = []
        for x in top.tolist():
            score = x >> _DOC_BITS
            if score <= 0:
                break
            out.append((low - (x & low), score))
        return out
