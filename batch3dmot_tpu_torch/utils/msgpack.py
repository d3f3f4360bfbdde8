"""A msgpack decoder for the files ``flax.serialization.to_bytes`` writes,
in numpy alone (the port reads the JAX package's checkpoints without the
``msgpack`` module).

:func:`unpackb` decodes the msgpack subset those files use: maps, arrays
(as lists), str, bin, nil, bool, ints, float32/64 and ext. :func:`restore`
is the counterpart of ``flax.serialization.msgpack_restore``: flax's ext
types become numpy values (code 1: an ndarray, encoded as the msgpack
triple (shape, dtype name, C-order bytes); code 3: a numpy scalar, the
same triple of a 0-d array; code 2: a Python complex), and arrays that
flax split into chunks are joined again. Truncated or malformed data
raises ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool, ext_hook: Optional[Callable]):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos} "
                             f"of {len(self.buf)}")
        out = self.buf[self.pos: end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if self.ext_hook is None:
            raise ValueError(f"msgpack ext type {code} without a decoder")
        return self.ext_hook(code, data)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        if b in _FIXED:
            return _FIXED[b](self)
        raise ValueError(f"malformed msgpack data: byte 0x{b:02x} at offset {self.pos - 1}")


_FIXED = {
    0xC0: lambda r: None,
    0xC2: lambda r: False,
    0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.unpack(">B"))),
    0xC5: lambda r: bytes(r.take(r.unpack(">H"))),
    0xC6: lambda r: bytes(r.take(r.unpack(">I"))),
    0xC7: lambda r: r.ext(r.unpack(">B")),
    0xC8: lambda r: r.ext(r.unpack(">H")),
    0xC9: lambda r: r.ext(r.unpack(">I")),
    0xCA: lambda r: r.unpack(">f"),
    0xCB: lambda r: r.unpack(">d"),
    0xCC: lambda r: r.unpack(">B"),
    0xCD: lambda r: r.unpack(">H"),
    0xCE: lambda r: r.unpack(">I"),
    0xCF: lambda r: r.unpack(">Q"),
    0xD0: lambda r: r.unpack(">b"),
    0xD1: lambda r: r.unpack(">h"),
    0xD2: lambda r: r.unpack(">i"),
    0xD3: lambda r: r.unpack(">q"),
    0xD4: lambda r: r.ext(1),
    0xD5: lambda r: r.ext(2),
    0xD6: lambda r: r.ext(4),
    0xD7: lambda r: r.ext(8),
    0xD8: lambda r: r.ext(16),
    0xD9: lambda r: r.str_(r.unpack(">B")),
    0xDA: lambda r: r.str_(r.unpack(">H")),
    0xDB: lambda r: r.str_(r.unpack(">I")),
    0xDC: lambda r: r.array(r.unpack(">H")),
    0xDD: lambda r: r.array(r.unpack(">I")),
    0xDE: lambda r: r.map(r.unpack(">H")),
    0xDF: lambda r: r.map(r.unpack(">I")),
}


def unpackb(data: bytes, raw: bool = False, ext_hook: Optional[Callable] = None) -> Any:
    """The one msgpack value that ``data`` holds (arrays as lists; str as
    ``bytes`` when ``raw``); ``ext_hook(code, data)`` decodes ext values."""
    reader = _Reader(data, raw, ext_hook)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"malformed msgpack data: {len(reader.buf) - reader.pos} bytes "
                         "after the value")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    try:
        dtype = np.dtype(dtype_name.decode())
    except TypeError as e:
        raise ValueError(f"unsupported array dtype {dtype_name!r} in msgpack data") from e
    return np.frombuffer(buffer, dtype=dtype).reshape(shape)


def _flax_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _as_tuple(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    """Arrays that flax split into ``{"__msgpack_chunked_array__": True,
    "shape": ..., "chunks": ...}`` maps joined again, everywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        return np.concatenate(_as_tuple(tree["chunks"])).reshape(_as_tuple(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives: nested
    dicts (flax stores tuples and lists as maps with keys "0", "1", ...)
    with numpy arrays (read-only views of ``data``), numpy scalars and
    Python values as leaves."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))


def read(path: str) -> Any:
    """:func:`restore` of the file at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())
