"""The flax ``serialization`` msgpack format, read and written with numpy.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``
(``improving_learned_index_tpu/core/checkpoint.py:30-63``): a msgpack tree of
maps with string keys whose array leaves are msgpack extension types.  The
port reads those files without flax and without a msgpack package:

- ext 1, an ndarray: a nested msgpack array ``[shape, dtype name, C-order
  bytes]``;
- ext 2, a Python complex: a nested ``[real, imag]``;
- ext 3, a numpy scalar: an ndarray of shape ``()``, unwrapped;
- a map ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
  {...}}``: a leaf flax split because it held more than ``MAX_CHUNK_SIZE``
  bytes, concatenated back.

numpy has no bfloat16: a ``bfloat16`` leaf comes back as a CPU
``torch.bfloat16`` tensor made from its raw uint16 bytes; every other leaf is
a numpy array (or scalar).  The file is read once; each array is an
``np.frombuffer`` view of its bytes in that buffer (read-only), so a
1.3 GB snapshot is not parsed byte by byte or copied leaf by leaf.

``write_bytes`` gives the bytes ``flax.serialization.to_bytes`` gives for the
same tree (lists and tuples become maps keyed ``"0"``, ``"1"``, ...,
namedtuples maps keyed by their fields, as flax's ``to_state_dict`` makes
them), so tests and the smoke run can make
the JAX package's files.  No CLI of the port writes this format.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any, Union

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_BF16 = "bfloat16"


# -- decode ---------------------------------------------------------------------

class _Reader:
    """One msgpack object at a time from a memoryview (a reading position
    and bounds checks; a short buffer raises ``ValueError``)."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}, "
                             f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
               0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}.get(b)
        if fmt is not None:
            return self.unpack(fmt)
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"invalid msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def array(self, n: int, raw: bool) -> list:
        return [self.obj(raw) for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return _unchunk(out) if _CHUNKED in out else out

    def ext(self, n: int) -> Any:
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == _EXT_COMPLEX:
            inner = _Reader(data)
            real, imag = inner.obj()
            inner.end()
            return complex(real, imag)
        raise ValueError(f"unknown msgpack ext type {code} (flax writes 1, 2 and 3)")

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError(f"{len(self.buf) - self.pos} bytes of extra data after the msgpack object")


def _ndarray(data: memoryview):
    """flax's ``_ndarray_from_bytes``: ``[shape, dtype name, bytes]``, the
    bytes taken in place."""
    inner = _Reader(data)
    n = inner.unpack("B")
    if n != 0x93:
        raise ValueError("a flax ndarray ext holds [shape, dtype, bytes]")
    shape = tuple(inner.obj())
    name = inner.obj(raw=True).decode()
    b = inner.unpack("B")
    size = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}.get(b)
    if size is None:
        raise ValueError("a flax ndarray ext's data must be msgpack bin")
    buf = inner.take(inner.unpack(size))
    inner.end()
    if name == _BF16:
        flat = np.frombuffer(buf, dtype=np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunk(d: dict):
    """flax's ``_unchunk``: the chunks of a split leaf, concatenated."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def read_bytes(data: Union[bytes, bytearray, memoryview]) -> Any:
    """The tree of one flax msgpack buffer (``flax.serialization.msgpack_restore``)."""
    reader = _Reader(memoryview(data))
    tree = reader.obj()
    reader.end()
    return tree


def read(path: Union[str, Path]) -> Any:
    """The tree of a flax msgpack file (one read of the whole file)."""
    return read_bytes(Path(path).read_bytes())


# -- encode ---------------------------------------------------------------------

def _head(out: bytearray, n: int, small: int, small_max: int, codes: tuple) -> None:
    """A length header: ``small | n`` up to ``small_max`` (when given), then
    the 8-, 16- and 32-bit forms in ``codes`` (None where the family has
    none)."""
    if small is not None and n <= small_max:
        out.append(small | n)
    elif codes[0] is not None and n <= 0xFF:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"{n} entries or bytes: too large for msgpack")


def _int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out += struct.pack("b", x)
    elif 0x80 <= x <= 0xFF:
        out += struct.pack("BB", 0xCC, x)
    elif -0x80 <= x < 0:
        out += struct.pack(">Bb", 0xD0, x)
    elif 0xFF < x <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, x)
    elif -0x8000 <= x < -0x80:
        out += struct.pack(">Bh", 0xD1, x)
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, x)
    elif -0x80000000 <= x < -0x8000:
        out += struct.pack(">Bi", 0xD2, x)
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, x)
    elif -0x8000000000000000 <= x < -0x80000000:
        out += struct.pack(">Bq", 0xD3, x)
    else:
        raise OverflowError("Integer value out of range")


def _str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
    out += b


def _bin(out: bytearray, b) -> None:
    _head(out, len(b), None, -1, (0xC4, 0xC5, 0xC6))
    out += b


def _ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}.get(n)
    if fixed is not None:
        out.append(fixed)
    else:
        _head(out, n, None, -1, (0xC7, 0xC8, 0xC9))
    out += struct.pack("b", code)
    out += data


def _as_numpy(x) -> tuple:
    """(array, dtype name) of an ndarray or tensor leaf; a bfloat16 tensor
    as its raw int16 bits."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), _BF16
        x = t.numpy()
    return x, x.dtype.name


def _ndarray_bytes(x) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of ``(shape, dtype name, bytes)``."""
    arr, name = _as_numpy(x)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported for serialization of ndarrays.")
    inner = bytearray([0x93])
    _head(inner, len(arr.shape), 0x90, 0x0F, (None, 0xDC, 0xDD))
    for d in arr.shape:
        _int(inner, int(d))
    _str(inner, name)
    _bin(inner, arr.tobytes("C"))
    return bytes(inner)


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.size * x.dtype.itemsize


def _chunk(x, max_chunk_size: int) -> dict:
    """flax's ``_chunk``: a leaf over ``max_chunk_size`` bytes as flat chunks."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    chunksize = max(1, int(max_chunk_size / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {
        _CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
        "chunks": {str(j): flat[i:i + chunksize] for j, i in enumerate(range(0, n, chunksize))},
    }


def _state_dict(x, max_chunk_size: int):
    """flax's ``to_state_dict`` for dicts, lists, tuples (keys as str) and
    namedtuples (keys their fields), then ``_chunk_array_leaves_in_place``."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            v = _state_dict(v, max_chunk_size)
            if _is_array(v) and _nbytes(v) > max_chunk_size:
                v = _chunk(v, max_chunk_size)
            out[str(k)] = v
        return out
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a namedtuple (optax states)
        return _state_dict({k: getattr(x, k) for k in x._fields}, max_chunk_size)
    if isinstance(x, (list, tuple)):
        return _state_dict({str(i): v for i, v in enumerate(x)}, max_chunk_size)
    return x


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif type(x) is bool:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _int(out, x)
    elif type(x) in (bytes, bytearray):
        _bin(out, x)
    elif type(x) is str:
        _str(out, x)
    elif type(x) is float:
        out += struct.pack(">Bd", 0xCB, x)
    elif type(x) is dict:
        _head(out, len(x), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif type(x) is list:
        _head(out, len(x), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif _is_array(x):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    elif isinstance(x, complex):
        inner = bytearray([0x92])
        _pack(inner, float(x.real))
        _pack(inner, float(x.imag))
        _ext(out, _EXT_COMPLEX, bytes(inner))
    else:
        raise TypeError(f"Cannot serialize {x!r}")


def write_bytes(tree: Any, max_chunk_size: int = MAX_CHUNK_SIZE) -> bytes:
    """``flax.serialization.to_bytes(tree)`` for a tree of dicts, lists and
    tuples with numpy, CPU tensor and Python leaves."""
    tree = _state_dict(tree, max_chunk_size)
    if _is_array(tree) and _nbytes(tree) > max_chunk_size:
        tree = _chunk(tree, max_chunk_size)
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def write(path: Union[str, Path], tree: Any) -> None:
    """``tree`` as a flax msgpack file, written to a temporary name and
    renamed into place."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(write_bytes(tree))
    os.replace(tmp, path)
