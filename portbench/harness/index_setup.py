"""Set-up shared by the cells of an index configuration: the index made on
the device from the seed, handed to the program's engine in memory, the
engine's kernels built and warmed, the query tokenizer, the query mix, and
what the checks and the metric readers need of the inputs."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from ..traffic.index import heavy_terms, make_index, term_names
from ..traffic.passages import SPECIAL_TOKENS
from ..traffic.queries import make_queries, query_text
from .common import Cell, log


@dataclass
class IndexSetup:
    offsets: np.ndarray
    docs: np.ndarray
    vals: np.ndarray
    terms: List[str]
    heavy: np.ndarray  # bool [T]: the term has a dense row under the configuration's budget
    engine: object
    tokenizer: object

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def work(self, query: Sequence[int]) -> int:
        """Postings a query reads."""
        return int(sum(self.lengths[t] for t in query))


def build(cell: Cell) -> IndexSetup:
    import torch

    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    cfg = cell.config
    dev = torch.device(cell.device)
    if dev.type == "cuda":
        from improving_learned_index_tpu_torch.ops import _kernels, gather_rows, scatter_scores
        from improving_learned_index_tpu_torch.ops.count_ge import KERNEL as COUNT_GE

        kernels = [gather_rows.KERNEL, scatter_scores.KERNEL, COUNT_GE]
        _kernels.build(kernels)
        for k in kernels:
            k.lib()
    terms = term_names(cfg["num_terms"])
    offsets, docs, vals = make_index(cfg, cell.seed, dev)
    if dev.type == "cuda":
        # the index stands in for one read from disk: the peak counts from here
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    index = InvertedIndexData(terms, offsets, docs, vals, num_docs=cfg["num_docs"])
    engine = HybridSearchEngine(index, heavy_min=cfg["heavy_min"], dense_budget_bytes=cfg["dense_budget_bytes"],
                                device=dev)
    tokenizer = ImpactTokenizer(WordPieceVocab(SPECIAL_TOKENS + terms))
    heavy = np.zeros(len(terms), bool)
    heavy[heavy_terms(np.diff(offsets), cfg)] = True
    log(f"index: {len(docs)} postings, {int(heavy.sum())} heavy terms, engine built")
    return IndexSetup(offsets, docs, vals, terms, heavy, engine, tokenizer)


def queries(setup: IndexSetup, n: int, traffic: Dict, seed: int, stream: int = 0):
    """(term-rank lists, texts) of ``n`` queries of the mix."""
    qs = make_queries(n, setup.terms, traffic, seed, stream)
    return qs, [query_text(q, setup.terms) for q in qs]


def batch_inputs(setup: IndexSetup, batch: Sequence[Sequence[int]], device) -> Dict[str, int]:
    """What a batch's stages read, whatever implements them: the dense rows
    it hits, the tail postings it touches, and the 32-byte sectors of the
    [nq, num_docs] fp32 score matrix those postings land in."""
    import torch

    hit = {t for q in batch for t in q if setup.heavy[t]}
    postings, keys = 0, []
    for row, q in enumerate(batch):
        for t in q:
            if setup.heavy[t]:
                continue
            s, e = int(setup.offsets[t]), int(setup.offsets[t + 1])
            postings += e - s
            d = torch.from_numpy(setup.docs[s:e].view(np.int32)).to(device).long()
            keys.append(row * (1 << 24) + d // 8)
    sectors = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    return {"nq": len(batch), "hit_rows": len(hit), "tail_postings": postings, "touched_sectors": sectors}


def sample(n: int, every: int, seed: int) -> np.ndarray:
    """The seeded sample of query positions to check: about one in ``every``."""
    rng = np.random.default_rng([int(seed), 5])
    return np.nonzero(rng.random(n) < 1.0 / every)[0]


def mismatches(setup: IndexSetup, num_docs: int, sampled: Dict[int, tuple], k: int, device,
               impact_bits: int = 8) -> int:
    """How many sampled answers differ from the reference's exact top-k
    (doc ids, scores and order), each ``(term ranks, answer rows)``, an
    answer that never came counting as one.  Runs after the engine is
    freed; ``impact_bits=4`` is the control."""
    from ..reference.scoring import Scorer

    scorer = Scorer(setup.offsets, setup.docs, setup.vals, num_docs, device, impact_bits)
    bad = 0
    for query, rows in sampled.values():
        want = scorer.topk(query, k)
        got = None if rows is None else [(int(d), float(s)) for d, s in rows]
        if got != [(d, float(s)) for d, s in want]:
            bad += 1
    del scorer
    return bad


def free_engine(setup: IndexSetup) -> None:
    import torch

    setup.engine.release()
    setup.engine = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
