"""A reader of flax's msgpack checkpoints in plain Python and NumPy.

The JAX trainer writes `flax.serialization.to_bytes({"params", "state",
"opt_state"})` (`nestinet_tpu/core/checkpoint.py:129-145`).  That is
msgpack of nested string-keyed maps whose leaves are:

  * ndarrays as ext type 1, whose payload is itself msgpack of
    `(shape, dtype name, raw C-order bytes)`;
  * NumPy scalars as ext type 3, the same payload of a 0-d array;
  * Python ints, floats, strings, booleans and None as themselves.

Tuples and namedtuples (optax's states) were turned into maps before
packing: a tuple's items are keyed "0", "1", ..., a namedtuple's by field
name.  An array over flax's chunk size (2^30 bytes) is stored as
`{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}` of
flat chunks; `loads` joins it back.

`loads` returns nested dicts of `np.ndarray`.  Each array is a read-only
view of the blob (`np.frombuffer`), so a 2 GB checkpoint is not copied
element by element; a joined chunked array is the one copy.  Only the
types flax writes are decoded: complex scalars (ext 2) and bfloat16 arrays
(which NumPy cannot hold without ml_dtypes) raise ValueError.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer; `raw` keeps strings as bytes (the
    ext payloads are packed that way, and flax reads them with raw=True)."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def _take(self, n: int) -> memoryview:
        start = self.pos
        self.pos += n
        if self.pos > len(self.buf):
            raise ValueError("truncated msgpack data")
        return self.buf[start:self.pos]

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        data = self._take(n)
        return bytes(data) if self.raw else str(data, "utf-8")

    def _ext(self, code: int, n: int):
        payload = self._take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _ndarray(payload)
            return arr[()] if code == EXT_NPSCALAR else arr
        raise ValueError(f"msgpack ext type {code} is not a flax array")

    def read(self):
        b = self.buf[self.pos]
        self.pos += 1
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32: a view, not a copy
            return self._take(self._unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b]))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self._unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self._ext(self._unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self._unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return self._ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte {b:#x} is not used by flax")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _ndarray(payload: memoryview) -> np.ndarray:
    """An ext-1 payload, msgpack of (shape, dtype name, bytes) -> a view."""
    shape, dtype_name, data = _Reader(payload, raw=True).read()
    name = bytes(dtype_name).decode()
    if name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported: NumPy has no bfloat16")
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Join flax's chunked arrays back into single arrays, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED_KEY in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def loads(blob) -> dict:
    """Decode one flax msgpack blob (bytes or any buffer) into nested dicts
    of numpy arrays and Python scalars."""
    reader = _Reader(blob)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after the msgpack object")
    return _unchunk(tree)


def load(path: str) -> dict:
    """`loads` of a file's bytes."""
    with open(path, "rb") as f:
        return loads(f.read())
