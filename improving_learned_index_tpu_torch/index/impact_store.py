"""Binary impact store: the array fast path through the indexing pipeline.

The port's copy of ``improving_learned_index_tpu/index/impact_store.py``
(numpy only; pinned to it byte for byte by ``tests/test_torch_impact_store.py``).

The reference pipeline moves per-document term impacts between stages as
text — the indexer writes "term: score, ..." lines
(src/deep_impact/indexing/indexer.py:55-66), quantize re-parses and
re-writes them (indexing/quantize.py:27-47), and the inverted-index creator
parses them a third time (inverted_index/create.py:12-55).  Every stage
pays ~9 bytes of Python text parsing per posting.

The encode stage already holds term ids and impact scores as arrays (each
batch's scores copied off the card once), so this store keeps them as flat
little-endian arrays on disk and the downstream stages (global-max
quantization, CSR inversion) become numpy array transforms — no text
round-trip.  The reference text formats remain fully supported
(``store_to_forward_text`` / ``store_from_forward_text`` convert
losslessly), and the final ``.dat/.idx/vocab`` artifact built from a store
is byte-identical to the one built through the text pipeline: the writer
stores ``round(value, 3)`` with Python-``round`` semantics, exactly the
value the text writer serializes (forward_index.format_line) and the text
parser reads back (repr round-trips).

On-disk layout (a directory)::

    meta.json      {"version": 2, "num_docs": N, "num_postings": P,
                    "quantized": bool, "bits": b, "max_val": float|None,
                    "values_format": "milli_i32"|"u8"|"f64"}
    format.json    {"values_format": ...} — written at writer START so a
                   crashed store's value dtype is recoverable
    vocab.txt      term strings, writer insertion order, one per line
    counts.bin     int32[N]    postings per document
    term_ids.bin   int32[P]    into vocab.txt line numbers
    values.bin     int32[P] impact millis (value = d/1000.0, bit-exactly
                   round(v, 3) — half the bytes of the legacy f64 format,
                   which remains readable), or uint8[P] quantized
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

PathLike = Union[str, Path]

_META = "meta.json"
_FORMAT = "format.json"
_VOCAB = "vocab.txt"
_COUNTS = "counts.bin"
_TERM_IDS = "term_ids.bin"
_VALUES = "values.bin"

# On-disk value encodings.  Unquantized impacts are EXACTLY round(v, 3) —
# i.e. the double nearest some integer d / 1000 — so they serialize as the
# int32 ``d`` ("milli_i32", half the bytes of f64) and reconstruct
# bit-identically via d / 1000.0 (one correctly-rounded division).  Legacy
# "f64" stores remain readable; quantized stores are raw uint8.
_VALUE_FORMATS = {
    "u8": np.uint8,
    "milli_i32": np.int32,
    "f64": np.float64,
}


def _disk_format(path: Path, quantized: bool) -> str:
    """Resolve a store's on-disk value format: meta.json (closed stores),
    else format.json (written at writer start, so crashed stores resolve),
    else the legacy default."""
    for name in (_META, _FORMAT):
        p = path / name
        if p.exists():
            with open(p) as f:
                fmt = json.load(f).get("values_format")
            if fmt is not None:
                return fmt
    return "u8" if quantized else "f64"

# flush buffered postings to disk every ~4M entries (~48 MB float path)
_FLUSH_POSTINGS = 1 << 22


def _exact_round3(v: np.ndarray) -> np.ndarray:
    """Vectorized round-to-3-decimals that matches Python ``round(x, 3)``
    bit-for-bit.

    ``rint(v*1000)/1000`` (half-even, like round) decides identically to the
    exact decimal rounding except when the f64 product ``v*1000`` lands
    within its own rounding error of a half boundary; those few values
    (measure: ~1e-6 of uniformly-distributed inputs) fall back to Python's
    correctly-rounded ``round``.  Needed because the text pipeline's values
    are ``float(repr(round(v, 3)))`` — byte parity of the final index
    requires the store to hold the identical doubles."""
    y = v * 1000.0
    out = np.rint(y) / 1000.0
    near = np.abs(y - np.floor(y) - 0.5) < 1e-6
    if near.any():
        for i in np.flatnonzero(near):
            out[i] = round(float(v[i]), 3)
    return out


def is_impact_store(path: PathLike) -> bool:
    p = Path(path)
    return p.is_dir() and (p / _META).exists()


class ImpactStoreWriter:
    """Streaming writer: one ``add_doc`` per document, O(1) memory.

    Crash-safe for resume: each flush appends new vocab terms BEFORE the
    posting arrays (so every flushed term id resolves), and ``resume=True``
    reopens a store left by a dead writer, truncating any torn final flush
    back to the last consistent document (``resume_docs`` tells the caller
    how many documents are already present)."""

    def __init__(
        self,
        path: PathLike,
        quantized: bool = False,
        bits: int = 8,
        resume: bool = False,
    ):
        self.path = Path(path)
        self.path.mkdir(parents=True, exist_ok=True)
        self.quantized = quantized
        self.bits = bits
        self.max_val: Optional[float] = None
        self._tid: Dict[str, int] = {}
        self._counts: List[int] = []
        self._ids: List[np.ndarray] = []
        self._vals: List[np.ndarray] = []
        self._buffered = 0
        self._num_postings = 0
        self._vocab_flushed = 0
        resuming = resume and (self.path / _COUNTS).exists()
        if resuming:
            self.values_format = _disk_format(self.path, quantized)
        else:
            self.values_format = "u8" if quantized else "milli_i32"
        self._val_dtype = _VALUE_FORMATS[self.values_format]
        self.resume_docs = 0
        if resuming:
            self.resume_docs = self._repair()
        mode = "ab" if resume else "wb"
        self._f_counts = open(self.path / _COUNTS, mode)
        self._f_ids = open(self.path / _TERM_IDS, mode)
        self._f_vals = open(self.path / _VALUES, mode)
        if not resuming:
            # a fresh writer invalidates any stale vocab/meta from a
            # previous run in the same directory, and records the value
            # format FIRST so a crashed store's dtype is recoverable
            for name in (_VOCAB, _META):
                (self.path / name).unlink(missing_ok=True)
            with open(self.path / _FORMAT, "w") as f:
                json.dump({"values_format": self.values_format}, f)
        self._closed = False

    def _repair(self) -> int:
        """Truncate a possibly-torn store to its last consistent document;
        reload the vocab.  Returns the number of intact documents."""
        vocab_path = self.path / _VOCAB
        if vocab_path.exists():
            with open(vocab_path, encoding="utf-8") as f:
                data = f.read()
            # drop a torn final line (no trailing newline)
            if data and not data.endswith("\n"):
                data = data[: data.rfind("\n") + 1]
                with open(vocab_path, "w", encoding="utf-8") as f:
                    f.write(data)
            terms = data.splitlines()
            self._tid = {t: i for i, t in enumerate(terms)}
            self._vocab_flushed = len(terms)
        item = np.dtype(self._val_dtype).itemsize
        n_counts = (self.path / _COUNTS).stat().st_size // 4
        n_ids = (self.path / _TERM_IDS).stat().st_size // 4
        n_vals = (self.path / _VALUES).stat().st_size // item
        counts = np.fromfile(self.path / _COUNTS, np.int32, count=n_counts)
        avail = min(n_ids, n_vals)
        cum = np.cumsum(counts, dtype=np.int64)
        n_docs = int(np.searchsorted(cum, avail, side="right"))
        keep = int(cum[n_docs - 1]) if n_docs else 0
        self.truncate_to(n_docs, counts=counts, keep_postings=keep)
        if keep:
            ids = np.fromfile(self.path / _TERM_IDS, np.int32, count=keep)
            if ids.size and int(ids.max()) >= self._vocab_flushed:
                raise ValueError(
                    f"{self.path}: term ids reference beyond the recovered "
                    "vocab — store is corrupt, rebuild from scratch"
                )
        self._num_postings = keep
        return n_docs

    def truncate_to(
        self,
        n_docs: int,
        counts: Optional[np.ndarray] = None,
        keep_postings: Optional[int] = None,
    ) -> None:
        """Truncate the on-disk arrays to the first ``n_docs`` documents
        (vocab may stay a superset; unused terms are compacted away by
        InvertedIndexData.from_impact_store)."""
        import os

        if counts is None:
            n_counts = (self.path / _COUNTS).stat().st_size // 4
            counts = np.fromfile(self.path / _COUNTS, np.int32, count=n_counts)
        if keep_postings is None:
            keep_postings = int(counts[:n_docs].sum())
        item = np.dtype(self._val_dtype).itemsize
        os.truncate(self.path / _COUNTS, 4 * n_docs)
        os.truncate(self.path / _TERM_IDS, 4 * keep_postings)
        os.truncate(self.path / _VALUES, item * keep_postings)
        self._num_postings = int(keep_postings)
        self.resume_docs = int(n_docs)

    def add_doc_row(self, terms: Sequence[str], values: np.ndarray) -> None:
        """Vectorized ``add_doc`` for the encode hot loop: term list + score
        row straight from the device batch, no per-term tuple building.
        Stores exactly ``round(float(v), 3)`` per value (same as add_doc /
        the text writer) via ``_exact_round3``."""
        tid = self._tid
        n = len(terms)
        ids = np.fromiter(
            (tid.setdefault(t, len(tid)) for t in terms), np.int32, count=n
        )
        if self.quantized:
            vals = np.asarray(values[:n], self._val_dtype)
        else:
            rounded = _exact_round3(np.asarray(values[:n], np.float64))
            if self.values_format == "f64":  # resuming a legacy store
                vals = rounded
            else:
                # milli-int32 range check: NaN/inf (a diverged checkpoint) or
                # |v| > ~2.1e6 would cast to arbitrary wrapped int32 values
                # (numpy UB) and break the store's bit-exactness contract
                # silently.  NaN fails the comparison, so this catches both.
                if not np.all(np.abs(rounded) < 2_147_483.0):
                    raise ValueError(
                        "impact outside int32-milli range (NaN/inf or "
                        f"|v| >= 2147483): {rounded[np.argmax(np.abs(rounded))]!r}"
                    )
                # rounded is d/1000 for integer d: recover d exactly
                vals = np.rint(rounded * 1000.0).astype(np.int32)
        self._append(ids, vals)

    def add_doc(self, term_impacts: Sequence[Tuple[str, float]]) -> None:
        """Add one document's (term, impact) pairs (terms unique per doc,
        as the document processor guarantees — text/processor.py)."""
        tid = self._tid
        ids = np.empty(len(term_impacts), np.int32)
        vals = np.empty(len(term_impacts), self._val_dtype)
        for i, (term, value) in enumerate(term_impacts):
            t = tid.get(term)
            if t is None:
                t = len(tid)
                tid[term] = t
            ids[i] = t
            # text-writer parity: forward_index.format_line serializes
            # round(v, 3) and repr round-trips, so the text pipeline's
            # parsed value IS round(v, 3) — stored as integer millis d
            # (round(v,3) == d/1000.0 bit-exactly)
            if self.quantized:
                vals[i] = value
            elif self.values_format == "f64":  # resuming a legacy store
                vals[i] = round(float(value), 3)
            else:
                vals[i] = round(round(float(value), 3) * 1000.0)
        self._append(ids, vals)

    def add_doc_ids(self, term_ids: np.ndarray, values: np.ndarray) -> None:
        """Add one document with pre-mapped term ids (the caller owns the
        vocab; pair with ``set_vocab``)."""
        self._append(
            np.asarray(term_ids, np.int32),
            np.asarray(values, self._val_dtype),
        )

    def set_vocab(self, vocab: Sequence[str]) -> None:
        self._tid = {t: i for i, t in enumerate(vocab)}

    def _append(self, ids: np.ndarray, vals: np.ndarray) -> None:
        self._counts.append(len(ids))
        self._ids.append(ids)
        self._vals.append(vals)
        self._buffered += len(ids)
        self._num_postings += len(ids)
        if self._buffered >= _FLUSH_POSTINGS:
            self._flush()

    def _flush(self) -> None:
        # vocab FIRST: every term id flushed below must resolve after a
        # crash (resume reads vocab to rebuild the id map)
        self._flush_vocab()
        if self._counts:
            np.asarray(self._counts, np.int32).tofile(self._f_counts)
            self._counts = []
        if self._ids:
            np.concatenate(self._ids).tofile(self._f_ids)
            np.concatenate(self._vals).tofile(self._f_vals)
            self._ids, self._vals = [], []
        self._buffered = 0

    def _flush_vocab(self) -> None:
        if len(self._tid) == self._vocab_flushed:
            return
        new_terms = list(self._tid)[self._vocab_flushed:]
        with open(self.path / _VOCAB, "a", encoding="utf-8") as f:
            for term in new_terms:
                f.write(term + "\n")
        self._vocab_flushed = len(self._tid)

    def close(self) -> None:
        if self._closed:
            return
        self._flush()
        for f in (self._f_counts, self._f_ids, self._f_vals):
            f.close()
        if not (self.path / _VOCAB).exists():
            (self.path / _VOCAB).touch()
        meta = {
            "version": 2,
            "num_docs": int(
                np.fromfile(self.path / _COUNTS, np.int32).size
            ),
            "num_postings": int(self._num_postings),
            "quantized": bool(self.quantized),
            "bits": int(self.bits),
            "max_val": self.max_val,
            "values_format": self.values_format,
        }
        with open(self.path / _META, "w") as f:
            json.dump(meta, f)
        self._closed = True

    def __enter__(self) -> "ImpactStoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ImpactStore:
    """Memory-mapped reader over a store directory."""

    def __init__(self, path: PathLike):
        self.path = Path(path)
        with open(self.path / _META) as f:
            self.meta = json.load(f)
        with open(self.path / _VOCAB, encoding="utf-8") as f:
            self.vocab: List[str] = [line.rstrip("\n") for line in f]
        self.quantized: bool = self.meta["quantized"]
        self.bits: int = self.meta.get("bits", 8)
        self.max_val: Optional[float] = self.meta.get("max_val")
        self.values_format: str = self.meta.get(
            "values_format", "u8" if self.quantized else "f64"
        )
        self.counts = np.fromfile(self.path / _COUNTS, np.int32)

        def _mm(name, dtype):
            # np.memmap refuses zero-length files; an empty store (empty
            # collection, or every doc zeroed every term) is legitimate
            if (self.path / name).stat().st_size == 0:
                return np.empty(0, dtype)
            return np.memmap(self.path / name, dtype, mode="r")

        self.term_ids = _mm(_TERM_IDS, np.int32)
        self.values = _mm(_VALUES, _VALUE_FORMATS[self.values_format])
        self.offsets = np.zeros(len(self.counts) + 1, np.int64)
        np.cumsum(self.counts, out=self.offsets[1:])
        assert self.offsets[-1] == len(self.term_ids) == len(self.values), (
            "impact store postings/count mismatch"
        )

    @property
    def num_docs(self) -> int:
        return len(self.counts)

    @property
    def num_postings(self) -> int:
        return int(self.offsets[-1])

    def value_block(self, lo: int, hi: int) -> np.ndarray:
        """Values [lo, hi) decoded to their logical dtype: float64 impacts
        (exactly round(v, 3)) for unquantized stores, uint8 for quantized."""
        block = np.asarray(self.values[lo:hi])
        if self.values_format == "milli_i32":
            return block.astype(np.float64) / 1000.0
        return block

    def global_max(self, chunk: int = 64 << 20) -> float:
        """Max impact over the store, chunked (never materializes all
        values).  Max commutes with the monotone milli decode."""
        mx = 0.0
        for lo in range(0, self.num_postings, chunk):
            block = self.values[lo : lo + chunk]
            if block.size:
                mx = max(mx, float(np.max(block)))
        if self.values_format == "milli_i32":
            mx = np.float64(mx) / 1000.0
        return float(mx)

    def doc(self, doc_id: int) -> Tuple[np.ndarray, np.ndarray]:
        s, e = self.offsets[doc_id], self.offsets[doc_id + 1]
        return self.term_ids[s:e], self.value_block(int(s), int(e))

    def iter_docs(self) -> Iterator[Tuple[int, Dict[str, float]]]:
        """Forward-index-compatible iteration (term-string dicts)."""
        vocab = self.vocab
        for doc_id in range(self.num_docs):
            ids, vals = self.doc(doc_id)
            yield doc_id, {vocab[t]: v for t, v in zip(ids.tolist(), vals.tolist())}


def quantize_store(
    input_path: PathLike,
    output_path: PathLike,
    max_val: Optional[float] = None,
    bits: int = 8,
    doc_block: int = 1 << 20,
) -> float:
    """Array-speed global-max quantization, exact ``quantize_file`` semantics
    (reference indexing/quantize.py:13-47): ``scale = (2^b - 1) / max``,
    ``q = trunc(v * scale)`` in float64, zero-quantized postings dropped.

    Processes ``doc_block`` documents at a time over the memory-mapped
    store, so host RSS stays ~25 B/posting-in-block regardless of corpus
    size (40M-doc corpora would otherwise need the full posting arrays in
    RAM at once)."""
    store = ImpactStore(input_path)
    if store.quantized:
        raise ValueError(f"{input_path} is already quantized")
    n_docs = store.num_docs
    if max_val is None:
        max_val = store.global_max() or 1.0
    scale = ((1 << bits) - 1) / max_val
    out = Path(output_path)
    out.mkdir(parents=True, exist_ok=True)
    total_kept = 0
    with open(out / _COUNTS, "wb") as fc, open(out / _TERM_IDS, "wb") as fi, open(
        out / _VALUES, "wb"
    ) as fv:
        for d0 in range(0, n_docs, doc_block):
            d1 = min(d0 + doc_block, n_docs)
            s, e = int(store.offsets[d0]), int(store.offsets[d1])
            counts = store.counts[d0:d1].astype(np.int64)
            # clamp, don't cast-wrap: with a caller-supplied max_val below
            # the true max, q > 255 would wrap modulo 256 (300 -> 44) and
            # the LARGEST impacts would become the smallest.  The clamp
            # matches InvertedIndexData.build (inverted.py) and the text
            # path's downstream uint8 handling.
            q = np.minimum(np.trunc(store.value_block(s, e) * scale),
                           (1 << bits) - 1)
            keep = q > 0
            doc_of = np.repeat(np.arange(d1 - d0, dtype=np.int64), counts)
            np.bincount(doc_of[keep], minlength=d1 - d0).astype(np.int32).tofile(fc)
            np.asarray(store.term_ids[s:e])[keep].tofile(fi)
            q[keep].astype(np.uint8).tofile(fv)
            total_kept += int(keep.sum())
        if n_docs == 0:
            pass  # empty store: zero-length files are the correct output
    with open(out / _VOCAB, "w", encoding="utf-8") as f:
        for term in store.vocab:
            f.write(term + "\n")
    meta = {
        "version": 2,
        "num_docs": int(n_docs),
        "num_postings": total_kept,
        "quantized": True,
        "bits": int(bits),
        "max_val": float(max_val),
        "values_format": "u8",
    }
    with open(out / _META, "w") as f:
        json.dump(meta, f)
    return float(max_val)


def store_to_forward_text(store: Union[ImpactStore, PathLike], out_path: PathLike) -> None:
    """Write the store as the reference text forward index — byte-identical
    to what the text pipeline produces for the same documents
    (forward_index.format_line / format_quantized_line)."""
    if not isinstance(store, ImpactStore):
        store = ImpactStore(store)
    vocab = store.vocab
    offsets = store.offsets
    pair = "{}: {}".format
    # chunked like every other store stage: materializing all postings as
    # Python ints/strs costs GBs at the 40M+ posting scale the store targets
    doc_block = 65536
    with open(out_path, "w", encoding="utf-8") as f:
        for d0 in range(0, store.num_docs, doc_block):
            d1 = min(d0 + doc_block, store.num_docs)
            s0, e0 = int(offsets[d0]), int(offsets[d1])
            ids_list = np.asarray(store.term_ids[s0:e0]).tolist()
            if store.quantized:
                vals_list = np.asarray(store.values[s0:e0]).tolist()
            else:
                vals_list = [repr(v) for v in store.value_block(s0, e0).tolist()]
            for d in range(d0, d1):
                s, e = int(offsets[d]) - s0, int(offsets[d + 1]) - s0
                f.write(
                    ", ".join(
                        pair(vocab[t], v)
                        for t, v in zip(ids_list[s:e], vals_list[s:e])
                    )
                )
                f.write("\n")


def store_from_forward_text(
    input_path: PathLike, output_path: PathLike, quantized: bool = False
) -> ImpactStore:
    """Convert a reference-format text forward index into a store (pays the
    text parse once; every later stage then runs at array speed)."""
    from .forward_index import iter_forward_index

    with ImpactStoreWriter(output_path, quantized=quantized) as w:
        if quantized:
            for _, impacts in iter_forward_index(input_path):
                w.add_doc([(t, int(v)) for t, v in impacts.items()])
        else:
            for _, impacts in iter_forward_index(input_path):
                w.add_doc(list(impacts.items()))
    return ImpactStore(output_path)
