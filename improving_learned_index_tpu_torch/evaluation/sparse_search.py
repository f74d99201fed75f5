"""SparseSearch: encode a corpus in memory and score queries on the card.

Counterpart of ``improving_learned_index_tpu/evaluation/sparse_search.py``,
with the reference SparseSearch's semantics
(src/deep_impact/evaluation/nano_beir_evaluator.py:70-137): an in-memory
inverted index of the model's impacts, keeping only positive scores, no
quantization; a query scores the sum of its matched impacts, and the top-k
come back in score order, the lower doc id first among ties.

- Below ``search.select.HYBRID_MIN_DOCS`` (100,000 docs) the index is a
  float ``DeviceSearchEngine`` (flat [Q, num_docs] scatter, the
  ``scatter_scores`` kernel); from there a float ``HybridSearchEngine``
  (dense fp32 heavy rows through the ``gather_rows`` kernel, the tail
  through ``scatter_scores``).  The switch is read from this module's
  namespace, as the JAX package reads it.
- The corpus is encoded through ``get_impact_scores_batch_packed`` when the
  model has it (several short documents a row), else
  ``get_impact_scores_batch``.
- ``device`` is the engines' device: ``None`` means the model's (``cuda``
  for a model without one; without a CUDA device that raises).
  ``use_kernels=False`` on the card runs the kernels' plain versions, for
  cross-checks only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from ..core.logging import get_logger
from ..search.device_engine import DeviceSearchEngine
from ..search.hybrid_engine import HybridSearchEngine
from ..search.select import HYBRID_MIN_DOCS

logger = get_logger("sparse_search", stream=False)


class SparseSearch:
    def __init__(
        self,
        model,
        batch_size: int = 16,
        verbose: bool = False,
        use_packing: bool = True,
        device: Optional[Union[str, torch.device]] = None,
        use_kernels: Optional[bool] = None,
    ):
        self.model = model
        self.batch_size = batch_size
        self.verbose = verbose
        self.use_packing = use_packing
        self.device = device if device is not None else getattr(model, "device", None)
        self.use_kernels = use_kernels
        self.engine: Optional[Union[DeviceSearchEngine, HybridSearchEngine]] = None
        self.corpus_ids: List[str] = []

    def _build_index(self, corpus: Dict[str, str]) -> None:
        self.corpus_ids = list(corpus.keys())
        texts = list(corpus.values())

        # sequence-packed encode when the model has it: eval corpora are
        # short documents, so packing cuts the encode work at identical
        # term lists
        packed = (
            getattr(self.model, "get_impact_scores_batch_packed", None)
            if self.use_packing
            else None
        )

        def impacts():
            for i in range(0, len(texts), self.batch_size):
                batch = texts[i : i + self.batch_size]
                rows = (
                    packed(batch)
                    if packed is not None
                    else self.model.get_impact_scores_batch(batch)
                )
                yield from rows

        # corpus scale: the flat [Q, num_docs] accumulator stops being the
        # right shape; the hybrid engine's float mode takes over
        cls = HybridSearchEngine if len(texts) >= HYBRID_MIN_DOCS else DeviceSearchEngine
        self.engine = cls.from_term_impacts(
            impacts(), device=self.device, use_kernels=self.use_kernels
        )
        if self.verbose:
            logger.info(
                f"built in-memory index ({cls.__name__}): {len(self.engine.vocab)} terms over "
                f"{len(self.corpus_ids)} docs"
            )

    def search(
        self, queries: Dict[str, str], corpus: Dict[str, str], k: int = 1000
    ) -> Dict[str, Dict[str, float]]:
        if self.engine is None:
            self._build_index(corpus)
        qids = list(queries.keys())
        term_sets = [self.model.process_query(queries[qid]) for qid in qids]
        results: Dict[str, Dict[str, float]] = {}
        # scoring is on the card: large batches amortize the launches
        bs = max(self.batch_size, 512)
        for i in range(0, len(qids), bs):
            scored = self.engine.score_batch(term_sets[i : i + bs], top_k=k)
            for qid, ranked in zip(qids[i : i + bs], scored):
                results[qid] = {
                    self.corpus_ids[doc]: float(score) for doc, score in ranked
                }
        return results
