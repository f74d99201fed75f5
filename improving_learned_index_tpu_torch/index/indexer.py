"""Corpus encoding pipeline: stream collection -> host tokenize -> encode on
the card (batched) -> per-term impact gather -> forward index.

Counterpart of ``improving_learned_index_tpu/index/indexer.py`` (reference
Indexer, src/deep_impact/indexing/indexer.py:12-68).  A producer thread
tokenizes while the consumer keeps one device batch in flight: batch i+1 is
dispatched before batch i's scores are read, so the device->host copy and
the device's compute overlap the next step.  Packed and unpacked routes,
and the pairwise route: a ``DeepPairwiseImpact`` model encodes through its
own ``get_impact_scores_batch`` in batches of ``model_batch_size``, so its
``term1|term2`` composite postings reach the forward index.  The output is
the reference text forward index, the binary impact store
(index/impact_store.py), or both.  The consumer's regions
(``core.profiling.annotate``), a batch each: ``index/next_batch`` (its wait
on the producer), ``index/encode``, ``index/scores_to_host`` and
``index/write`` (the batch's forward-file lines); the producer has none.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from contextlib import nullcontext
from itertools import islice
from pathlib import Path
from queue import Queue
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.config import IndexConfig
from ..core.logging import get_logger
from ..core.profiling import annotate
from ..data.datasets import stream_collection
from ..text.packing import SequencePacker
from ..text.processor import DocumentEncoding
from .forward_index import format_line
from .impact_store import ImpactStoreWriter
from .inverted import InvertedIndexData

logger = get_logger("indexer")
PathLike = Union[str, Path]


class _ProducerError:
    """Queue marker carrying a producer-thread exception to the consumer.
    Without it, a tokenize/stream error would kill the thread before the
    None sentinel is enqueued and the consumer's queue.get() would wait
    forever instead of surfacing the error."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _queue_get(queue: Queue):
    item = queue.get()
    if isinstance(item, _ProducerError):
        raise item.exc
    return item


def _split_rows(scores, offsets, terms) -> List[Tuple[List[str], np.ndarray]]:
    """A dispatched batch's (terms, impact row) a document, its scores read
    to the host (``offsets``: each document's span of a packed batch's flat
    scores; None: a row a document)."""
    with annotate("index/scores_to_host"):
        scores = np.asarray(scores)
    if offsets is None:
        return [(doc_terms, scores[i]) for i, doc_terms in enumerate(terms)]
    return [(doc_terms, scores[offsets[i]:offsets[i + 1]]) for i, doc_terms in enumerate(terms)]


def _tokenize_producer(model, docs: Iterator[str], batch_size: int, queue: Queue):
    try:
        batch: List[DocumentEncoding] = []
        for doc in docs:
            batch.append(model.process_document(doc))
            if len(batch) == batch_size:
                queue.put(batch)
                batch = []
        if batch:
            queue.put(batch)
        queue.put(None)
    except BaseException as e:  # noqa: BLE001 -- must reach the consumer
        queue.put(_ProducerError(e))


def _pack_producer(model, packer: SequencePacker, docs: Iterable[str], queue: Queue):
    try:
        for doc in docs:
            for batch in packer.add(model.process_document(doc)):
                queue.put(batch)
        for batch in packer.flush():
            queue.put(batch)
        queue.put(None)
    except BaseException as e:  # noqa: BLE001 -- must reach the consumer
        queue.put(_ProducerError(e))


def _repair_text_forward(path: PathLike) -> int:
    """Truncate a torn final line (crash mid-write) and return the number of
    complete lines.  Chunked scan: O(bytes), O(1) memory."""
    p = Path(path)
    if not p.exists():
        return 0
    size = p.stat().st_size
    lines = 0
    last_nl_end = 0
    with open(p, "rb") as f:
        pos = 0
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            n = chunk.count(b"\n")
            if n:
                lines += n
                last_nl_end = pos + chunk.rfind(b"\n") + 1
            pos += len(chunk)
    if last_nl_end != size:
        os.truncate(p, last_nl_end)
    return lines


def _truncate_text_forward(path: PathLike, n_lines: int) -> None:
    """Truncate the file to its first ``n_lines`` lines."""
    if n_lines <= 0:
        os.truncate(path, 0)
        return
    remaining = n_lines
    offset = 0
    with open(path, "rb") as f:
        while remaining:
            chunk = f.read(1 << 24)
            if not chunk:
                raise ValueError(f"{path} has fewer than {n_lines} lines")
            n = chunk.count(b"\n")
            if n >= remaining:
                at = -1
                for _ in range(remaining):
                    at = chunk.find(b"\n", at + 1)
                offset += at + 1
                remaining = 0
            else:
                remaining -= n
                offset += len(chunk)
    os.truncate(path, offset)


class Indexer:
    """Streams a collection through the encoder, emitting per-document
    (term, impact) lists -- to a forward-index file, or accumulated in
    memory for direct inverted-index construction."""

    def __init__(self, model, config: IndexConfig = IndexConfig()):
        self.model = model
        self.config = config

    def encode_documents(self, documents: Iterable[str]) -> Iterator[List[Tuple[str, float]]]:
        """Yield [(term, impact), ...] per document."""
        for doc_terms, row in self.encode_document_rows(documents):
            yield [(t, float(row[j])) for j, t in enumerate(doc_terms)]

    def encode_document_rows(self, documents: Iterable[str]) -> Iterator[Tuple[List[str], np.ndarray]]:
        """Yield (terms, impact_row) per document, overlapping host
        tokenization with device compute via a bounded queue.

        Models with composite postings (DeepPairwiseImpact emits
        ``term1|term2`` entries, reference pairwise_impact.py:97-129) go
        through their own ``get_impact_scores_batch``."""
        for batch in self._encode_batches(documents):
            yield from batch

    def _encode_batches(self, documents: Iterable[str]) -> Iterator[List[Tuple[List[str], np.ndarray]]]:
        """Each model batch's [(terms, impact_row), ...], in document
        order."""
        from ..models.pairwise import DeepPairwiseImpact

        if isinstance(self.model, DeepPairwiseImpact):
            docs = iter(documents)
            while batch := list(islice(docs, self.config.model_batch_size)):
                yield [([t for t, _ in pairs], np.asarray([v for _, v in pairs], np.float64))
                       for pairs in self.model.get_impact_scores_batch(batch)]
            return

        queue: Queue = Queue(maxsize=4)
        if self.config.pack_sequences:
            packer = SequencePacker(self.config.max_length, self.config.model_batch_size, self.config.max_terms)
            target, args = _pack_producer, (self.model, packer, documents, queue)
        else:
            target, args = _tokenize_producer, (self.model, iter(documents), self.config.model_batch_size, queue)
        producer = threading.Thread(target=target, args=args, daemon=True)
        producer.start()
        pending: deque = deque()
        while True:
            with annotate("index/next_batch"):
                batch = _queue_get(queue)
            if batch is None:
                break
            with annotate("index/encode"):
                pending.append(self._dispatch(batch))
            if len(pending) > 1:
                yield _split_rows(*pending.popleft())
        while pending:
            yield _split_rows(*pending.popleft())
        producer.join()

    def _dispatch(self, batch):
        """Launch one batch's encode: (scores in flight to the host, each
        document's score offsets or None, each document's terms).  The
        packed route (text/packing.py) puts several documents in a row, with
        block-diagonal attention on the card and one flat term-score gather
        a batch; the unpacked route one document a row."""
        if self.config.pack_sequences:
            return self.model.encode_packed(batch, materialize=False), batch.term_offsets, batch.terms
        scores, terms = self.model.encode_term_scores(batch, max_terms=self.config.max_terms, materialize=False)
        return scores, None, terms

    def index_to_file(
        self,
        collection_path: PathLike,
        output_file_path: Optional[PathLike] = None,
        collection_type: str = "msmarco",
        log_every: int = 10000,
        store_path: Optional[PathLike] = None,
        resume: bool = False,
    ) -> int:
        """Encode the collection to a forward index.  ``output_file_path``
        writes the reference text format ("term: score" lines);
        ``store_path`` writes the binary impact store that the
        quantize/invert stages consume at array speed; either or both.

        ``resume=True`` continues a run killed mid-encode: both outputs are
        repaired to their last consistent document (torn tail lines and
        flushes truncated, dual outputs synced to the shorter one) and
        encoding restarts there.  Returns the total number of documents in
        the output(s)."""
        if output_file_path is None and store_path is None:
            raise ValueError("need output_file_path and/or store_path")
        done = 0
        store = None
        if store_path is not None:
            if self.config.round_decimals != 3:
                # the store encodes impacts as round(v, 3) integer millis; a
                # different text rounding would desynchronize the two outputs
                raise ValueError(
                    "store_path requires round_decimals=3 (the store's "
                    f"integer-milli encoding); got {self.config.round_decimals}"
                )
            store = ImpactStoreWriter(store_path, resume=resume)
            done = store.resume_docs
        if output_file_path is not None:
            done_text = _repair_text_forward(output_file_path) if resume else 0
            if store is not None and done_text != done:
                done = min(done, done_text)
                store.truncate_to(done)
                _truncate_text_forward(output_file_path, done)
            else:
                done = done_text
        if done:
            logger.info(f"resuming at document {done}")

        start = time.time()
        count = 0
        docs = (passage for _, passage in stream_collection(collection_path, collection_type))
        docs = islice(docs, done, None) if done else docs
        out_cm = (
            open(output_file_path, "a" if resume else "w", encoding="utf-8")
            if output_file_path is not None
            else nullcontext(None)
        )
        with out_cm as out, (store if store is not None else nullcontext()):
            for batch in self._encode_batches(docs):
                with annotate("index/write"):
                    for doc_terms, row in batch:
                        if out is not None:
                            out.write(
                                format_line(
                                    [(t, float(row[j])) for j, t in enumerate(doc_terms)],
                                    self.config.round_decimals,
                                )
                                + "\n"
                            )
                        if store is not None:
                            store.add_doc_row(doc_terms, row)
                        count += 1
                        if count % log_every == 0:
                            rate = count / (time.time() - start)
                            logger.info(f"indexed {count} passages [{rate:.2f} passages/s]")
        return done + count

    def build_inverted(
        self,
        documents: Sequence[str],
        quantize_bits: Optional[int] = None,
    ) -> Tuple[InvertedIndexData, float]:
        """End-to-end in-memory build: encode -> global-max quantize ->
        postings.  Returns (index, max_impact used as the quantization range)."""
        if quantize_bits is None:
            quantize_bits = self.config.quantization_bits
        per_doc: List[List[Tuple[str, float]]] = list(self.encode_documents(documents))
        max_val = 0.0
        for doc in per_doc:
            for _, v in doc:
                max_val = max(max_val, v)
        if max_val <= 0:
            max_val = 1.0
        scale = ((1 << quantize_bits) - 1) / max_val

        def gen():
            for doc_id, doc in enumerate(per_doc):
                yield doc_id, {t: int(v * scale) for t, v in doc}

        return InvertedIndexData.build(gen(), num_docs=len(per_doc)), max_val
