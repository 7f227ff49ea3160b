"""Read the ``.msgpack`` files that Flax's ``serialization.to_bytes`` writes,
without Flax and without the ``msgpack`` package.

The JAX package saves its final parameters that way
(``train/checkpoint.py::save_params``).  This reader knows the subset of
MessagePack that such a file uses: maps, strings, binaries, arrays,
integers, floats, nil and booleans, and Flax's extension types 1 (an
n-d array) and 3 (a numpy scalar), each of them a packed ``(shape, dtype
name, C-order bytes)``.  Arrays come back as CPU tensors; ``"bfloat16"``
is read as uint16 and viewed as ``torch.bfloat16``.  Anything else
raises ``ValueError`` and is not guessed at: Flax's complex numbers (ext
code 2), other ext codes, and the ``'__msgpack_chunked_array__'`` maps
that Flax writes for arrays above 2**30 bytes.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["msgpack_restore", "load_msgpack", "CHUNKED_KEY"]

CHUNKED_KEY = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
# fixed-size formats: first byte → (struct code, payload size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# first byte → size of the length field that follows it
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, size: int) -> int:
        return struct.unpack(_UINT[size], self.take(size))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            code, size = _FIXED[b]
            return struct.unpack(code, self.take(size))[0]
        if b in _STR:
            return str(self.take(self.uint(_STR[b])), "utf-8")
        if b in _BIN:
            return bytes(self.take(self.uint(_BIN[b])))
        if b in _ARRAY:
            return [self.value() for _ in range(self.uint(_ARRAY[b]))]
        if b in _MAP:
            return self.map(self.uint(_MAP[b]))
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.uint(_EXT[b]))
        raise ValueError(f"msgpack byte 0x{b:02x} at offset {self.pos - 1} is not a value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if CHUNKED_KEY in out:
            raise ValueError("a chunked array (Flax splits arrays above 2**30 bytes) is not "
                             "supported")
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext code {code} is not a Flax array or numpy scalar")
        return _array(payload, scalar=code == _EXT_NPSCALAR)


def _array(payload: bytes, scalar: bool) -> torch.Tensor:
    """Flax's packed ``(shape, dtype name, C-order bytes)`` → a CPU tensor
    (0-dimensional for a numpy scalar)."""
    reader = _Reader(payload)
    fields = reader.value()
    if reader.pos != len(payload) or not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("a Flax array is a packed (shape, dtype, bytes) triple")
    shape, name, buffer = fields
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        arr = np.frombuffer(buffer, dtype="<u2").reshape(shape)
        out = torch.from_numpy(arr.copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(buffer, dtype=np.dtype(name).newbyteorder("<")).reshape(shape)
        out = torch.from_numpy(arr.astype(arr.dtype.newbyteorder("="), copy=True))
    if scalar and out.dim() != 0:
        raise ValueError(f"a numpy scalar of shape {tuple(out.shape)}")
    return out


def msgpack_restore(data: bytes) -> Any:
    """The Python tree of a Flax ``.msgpack`` payload: dicts, lists,
    scalars and CPU tensors (see the module docstring)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes left after the msgpack value")
    return out


def load_msgpack(path) -> Any:
    """:func:`msgpack_restore` of a file."""
    return msgpack_restore(Path(path).read_bytes())
