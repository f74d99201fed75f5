"""DeepImpact model wrapper: tokenizer + encoder + on-device term scoring.

Counterpart of ``improving_learned_index_tpu/models/deep_impact.py``, with
the reference's model API surface (src/deep_impact/models/original.py:96-333,
xlmr_original.py:87-267): ``process_query`` / ``process_document`` /
``process_query_and_document`` / ``compute_term_impacts`` /
``get_impact_scores`` / ``get_impact_scores_batch``.

- The model lives on the card unless the caller passes ``device="cpu"``;
  without a CUDA device the constructor raises.
- The term-score gather happens on the device: the [B, L] token scores are
  indexed at the term slots (one flat gather when packed) and only [B, T]
  or [P] values cross to the host (the reference pulls the full output to
  the CPU first, original.py:282).
- ``materialize=False`` returns a ``HostCopy``: a non-blocking copy into
  pinned host memory with a CUDA event, so the indexer can dispatch the next
  batch before this one's scores are read.  ``np.asarray`` on it waits.
- Eager PyTorch compiles nothing, so batches are not padded to bucket
  sizes as the JAX wrapper pads them for XLA.
- ``use_kernels=False`` on the card runs the plain attention, for
  cross-checks only.
- ``devices=[...]`` (in place of ``device``): data-parallel encode (JAX
  ``DeepImpact(mesh=)``, the reference's DataParallel indexer,
  indexing/indexer.py:25-26).  ``self.module`` lives on ``devices[0]``, and
  each other distinct device holds a replica copied from it;
  ``encode_term_scores`` and ``encode_packed`` split each batch into
  contiguous parts, one per list entry (``["cuda:0"] * 2``: two parts on
  one card), run each part on its device's module with that device
  current, and gather the outputs on ``devices[0]`` in row order.  The JAX
  wrapper pads the batch to a multiple of the data axis; a row's output
  does not depend on the other rows, so the parts are split unpadded.  A
  change to ``self.module``'s tensors in place (a training step,
  ``load_state_dict``) is copied to the replicas before the next encode.
  ``use_kernels`` is resolved per device.

Random init (no checkpoint) uses ``torch.Generator(seed)`` with flax's
initializer shapes and scales; it does not reproduce flax's numbers.

``DeepImpactCrossEncoder`` (JAX ``models/deep_impact.py:280-328``) scores
"{document} [SEP] {query}" from the [CLS] state; it takes a DeepImpact
state dict as it is.  It encodes on one device (its ``score_batch`` takes
no part of ``devices``), as the JAX one only stores its ``mesh``.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch

from ..core.config import EncoderConfig
from ..core.device import device_scope, resolve_device, resolve_use_kernels
from ..text.processor import DocumentEncoding, batch_arrays, batch_term_slots
from .encoder import CrossEncoderModel, DeepImpactModel, init_weights


class HostCopy:
    """Device values on their way to pinned host memory; ``np.asarray``
    waits for the copy and returns the host array."""

    def __init__(self, values: torch.Tensor):
        if values.device.type == "cuda":
            self._host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
            self._host.copy_(values, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host, self._event = values.clone(), None

    def __array__(self, dtype=None, copy=None):
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy()
        return out if dtype is None else out.astype(dtype)


def part_bounds(rows: int, parts: int) -> np.ndarray:
    """The row bounds [parts + 1] of the data-parallel encode's contiguous
    parts of a ``rows``-row batch."""
    return np.linspace(0, rows, parts + 1).round().astype(int)


class DeepImpact:
    """Term-impact encoder with a pluggable tokenizer (BERT/RoBERTa/XLM-R trunk)."""

    module_class = DeepImpactModel

    def __init__(
        self,
        config: EncoderConfig,
        tokenizer,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        use_kernels: Optional[bool] = None,
        devices: Optional[Sequence[Union[str, torch.device]]] = None,
    ):
        if devices is not None:
            if not devices:
                raise ValueError("devices must name at least one device")
            if device is not None:
                raise ValueError("pass device or devices, not both (devices[0] holds the outputs)")
            device = devices[0]
        self.device = resolve_device(device)
        self.devices = [self.device] if devices is None else [resolve_device(d) for d in devices]
        self.use_kernels = resolve_use_kernels(self.device, use_kernels)
        self.config = config
        self.tokenizer = tokenizer
        self.module = self.module_class(config)
        if state_dict is None:
            g = torch.Generator()
            g.manual_seed(seed)
            init_weights(self.module, g)
        else:
            self._load_state_dict(state_dict, seed)
        # one module a distinct device: (module, use_kernels)
        self._replicas = {}
        for dev in self.devices:
            if dev not in self._replicas and dev != self.device:
                self._replicas[dev] = (copy.deepcopy(self.module).to(dev).eval(),
                                       resolve_use_kernels(dev, use_kernels))
        self.module.to(self.device).eval()
        self._replicas[self.device] = (self.module, self.use_kernels)
        self._synced = self._weights_stamp()
        self.max_length = getattr(tokenizer, "max_length", config.max_position_embeddings)

    def _weights_stamp(self):
        """Which tensors ``self.module`` holds and their in-place version
        counts: a training step or ``load_state_dict`` changes it."""
        return [(id(t), t._version) for t in self.module.state_dict(keep_vars=True).values()]

    def _sync_replicas(self) -> None:
        """Copy ``self.module``'s weights to the other devices' replicas if
        they changed since the last copy."""
        if len(self._replicas) == 1:
            return
        stamp = self._weights_stamp()
        if stamp == self._synced:
            return
        state = self.module.state_dict()
        for replica, _ in self._replicas.values():
            if replica is not self.module:
                replica.load_state_dict(state)
        self._synced = stamp

    def _load_state_dict(self, state_dict: Dict[str, torch.Tensor], seed: int) -> None:
        self.module.load_state_dict(state_dict)

    # -- text API (delegates to the pluggable tokenizer) ---------------------
    def process_query(self, query: str) -> Set[str]:
        return self.tokenizer.process_query(query)

    def process_document(self, document: str, max_length: Optional[int] = None) -> DocumentEncoding:
        return self.tokenizer.process_document(document, max_length=max_length)

    def process_query_and_document(self, query: str, document: str, max_length: Optional[int] = None):
        return self.tokenizer.process_query_and_document(query, document, max_length=max_length)

    # -- forward --------------------------------------------------------------
    def _upload(self, array: np.ndarray, device: Optional[torch.device] = None) -> torch.Tensor:
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(array))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def _forward_parts(self, arrays: Sequence[np.ndarray], segmented: bool = False) -> torch.Tensor:
        """The module's [B, L] token scores on ``self.device`` for the int
        arrays (input_ids, attention_mask or segment ids, type_ids), split
        by rows into one contiguous part per entry of ``self.devices``, each
        part on its device's module with that device current (the kernels
        launch on the current device), gathered in row order."""
        self._sync_replicas()
        bounds = part_bounds(len(arrays[0]), len(self.devices))
        outs = []
        for dev, lo, hi in zip(self.devices, bounds[:-1], bounds[1:]):
            if lo == hi:
                continue
            module, use_kernels = self._replicas[dev]
            with device_scope(dev):
                ids, second, types = (self._upload(a[lo:hi], dev) for a in arrays)
                if segmented:
                    out = module(ids, (second > 0).to(torch.int32), types, segment_ids=second,
                                 use_kernels=use_kernels)
                else:
                    out = module(ids, second, types, use_kernels=use_kernels)
            outs.append(out[..., 0].to(self.device))
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    @torch.inference_mode()
    def __call__(self, input_ids, attention_mask, type_ids=None) -> np.ndarray:
        """Raw [B, L, 1] impact scores (host numpy) for int arrays."""
        if type_ids is None:
            type_ids = np.zeros_like(np.asarray(input_ids))
        out = self.module(
            self._upload(np.asarray(input_ids, np.int32)),
            self._upload(np.asarray(attention_mask, np.int32)),
            self._upload(np.asarray(type_ids, np.int32)),
            use_kernels=self.use_kernels,
        )
        return out.float().cpu().numpy()

    @torch.inference_mode()
    def encode_term_scores(
        self,
        encodings: Sequence[DocumentEncoding],
        max_terms: Optional[int] = None,
        materialize: bool = True,
    ):
        """Encode documents, returning ([B, T] term scores, per-doc term lists).

        ``materialize=False`` returns the scores as a ``HostCopy`` in flight
        (no host sync) so callers can pipeline batches."""
        if not encodings:
            return np.zeros((0, 0), dtype=np.float32), []
        if max_terms is None:
            max_terms = self.max_length
        arrays = batch_arrays(encodings)
        slots, _, terms = batch_term_slots(encodings, max_terms)
        out = self._forward_parts([arrays["input_ids"], arrays["attention_mask"], arrays["type_ids"]])
        scores = torch.take_along_dim(out, self._upload(slots).long(), dim=1)
        pending = HostCopy(scores)
        return (np.asarray(pending) if materialize else pending), terms

    @torch.inference_mode()
    def encode_packed(self, batch, materialize: bool = True):
        """Encode one ``text.packing.PackedBatch``; returns the flat [P]
        term-score array (a ``HostCopy`` in flight when
        ``materialize=False``).  Split per document with
        ``batch.term_offsets``."""
        # flat_slots index the whole [R, S] output: the parts are gathered first
        out = self._forward_parts([batch.input_ids, batch.segment_ids, batch.type_ids], segmented=True)
        scores = out.reshape(-1)[self._upload(batch.flat_slots).long()]
        pending = HostCopy(scores)
        return np.asarray(pending) if materialize else pending

    def get_impact_scores_batch_packed(
        self, documents: Sequence[str], rows: Optional[int] = None
    ) -> List[List[Tuple[str, float]]]:
        """``get_impact_scores_batch`` through the sequence-packed encode
        path: same output, fewer FLOPs on short-document corpora."""
        from ..text.packing import pack_documents

        if not documents:
            return []
        encodings = [self.process_document(d) for d in documents]
        if rows is None:
            # enough rows for the whole batch at ~85% fill
            total = sum(sum(e.attention_mask) for e in encodings)
            rows = min(-(-int(total * 1.18) // self.max_length) or 1, len(encodings))
        out: List[List[Tuple[str, float]]] = []
        for batch in pack_documents(encodings, self.max_length, rows):
            scores = self.encode_packed(batch)
            offs = batch.term_offsets
            for i, terms in enumerate(batch.terms):
                row = scores[offs[i] : offs[i + 1]]
                out.append([(t, float(row[j])) for j, t in enumerate(terms)])
        return out

    # -- reference-parity impact API -------------------------------------------
    @staticmethod
    def compute_term_impacts(
        documents_term_to_token_index_map: Sequence[Dict[str, int]],
        outputs,
    ) -> List[List[Tuple[str, float]]]:
        """Gather per-term impacts from raw [B, L, 1] outputs
        (reference original.py:271-291)."""
        if isinstance(outputs, torch.Tensor):
            outputs = outputs.detach().float().cpu().numpy()
        impact_scores = np.asarray(outputs)[..., 0]
        return [
            [(term, float(impact_scores[i][idx])) for term, idx in term_map.items()]
            for i, term_map in enumerate(documents_term_to_token_index_map)
        ]

    def get_impact_scores(self, document: str) -> List[Tuple[str, float]]:
        return self.get_impact_scores_batch([document])[0]

    def get_impact_scores_batch(self, documents: Sequence[str]) -> List[List[Tuple[str, float]]]:
        encodings = [self.process_document(d) for d in documents]
        scores, terms = self.encode_term_scores(encodings)
        return [
            [(t, float(scores[i, j])) for j, t in enumerate(doc_terms)]
            for i, doc_terms in enumerate(terms)
        ]

    # -- persistence ------------------------------------------------------------
    def save(self, path) -> None:
        """The module's state dict as one ``.pt`` file (``core.checkpoint``)."""
        from ..core.checkpoint import save_params

        save_params(path, self.module.state_dict())

    @classmethod
    def load(cls, config: EncoderConfig, tokenizer, checkpoint_path=None, **kwargs) -> "DeepImpact":
        """A model from a ``save`` file, a ``Trainer`` snapshot (its params
        unwrapped) or a JAX package ``.msgpack`` checkpoint."""
        if checkpoint_path is not None:
            from ..core.checkpoint import load_params

            kwargs["state_dict"] = load_params(checkpoint_path, config)
        return cls(config, tokenizer, **kwargs)


class DeepImpactCrossEncoder(DeepImpact):
    """Relevance scoring from the [CLS] state of "{doc} [SEP] {query}"
    (reference models/cross_encoder.py)."""

    module_class = CrossEncoderModel

    def process_cross_encoder_document_and_query(self, document: str, query: str) -> DocumentEncoding:
        return self.tokenizer.process_document(f"{document} [SEP] {query}")

    def process_cross_encoder_documents_and_query(
        self, documents: Sequence[str], query: str
    ) -> List[DocumentEncoding]:
        return [self.process_cross_encoder_document_and_query(d, query) for d in documents]

    @torch.inference_mode()
    def score_batch(self, encodings: Sequence[DocumentEncoding]) -> np.ndarray:
        """[n] fp32 scores (host numpy).  Rows are encoded as they come: no
        row is padded in, so no score depends on the batch's size."""
        if not encodings:
            return np.zeros((0,), dtype=np.float32)
        arrays = batch_arrays(encodings)
        out = self.module(
            self._upload(arrays["input_ids"]),
            self._upload(arrays["attention_mask"]),
            self._upload(arrays["type_ids"]),
            use_kernels=self.use_kernels,
        )  # [n, 1]
        return out[:, 0].float().cpu().numpy()
