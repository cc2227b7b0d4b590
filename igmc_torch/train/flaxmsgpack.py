"""A stdlib decoder for the JAX package's `.ckpt` checkpoints.

The JAX package writes its checkpoints with
`flax.serialization.to_bytes`: a msgpack document of the pytree's state
dict. This module reads the part of msgpack that such a file of
parameters holds, with no msgpack or flax package:

  * nil, bool, ints (fixint, int8-64, uint8-64), float32 / float64, str,
    bin, arrays and maps;
  * flax's ndarray ext type (code 1): [shape, dtype name, raw C-order
    buffer];
  * lists and tuples, which flax stores as maps with keys "0", "1", ...,
    turned back into lists by `restore_lists`.

Anything else (another ext type, such as flax's complex (2) or NumPy
scalar (3), a dtype NumPy does not name, bfloat16, a truncated document)
raises ValueError naming it.
"""

from __future__ import annotations

import struct

import numpy as np

_EXT_NDARRAY = 1
# fixed-width formats: first byte -> (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError(f"truncated msgpack document: {n} bytes wanted at "
                             f"offset {self.pos} of {len(self.data)}")
        out = self.data[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, size: int) -> int:
        return self.unpack(_LEN[size], size)

    def value(self):
        b = self.unpack(">B", 1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return self.text(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if 0xc4 <= b <= 0xc6:                        # bin 8 / 16 / 32
            return bytes(self.take(self.length(1 << (b - 0xc4))))
        if 0xc7 <= b <= 0xc9:                        # ext 8 / 16 / 32
            n = self.length(1 << (b - 0xc7))
            return self.ext(self.unpack(">b", 1), n)
        if 0xd4 <= b <= 0xd8:                        # fixext 1 .. 16
            return self.ext(self.unpack(">b", 1), 1 << (b - 0xd4))
        if 0xd9 <= b <= 0xdb:                        # str 8 / 16 / 32
            return self.text(self.length(1 << (b - 0xd9)))
        if b in (0xdc, 0xdd):                        # array 16 / 32
            return [self.value() for _ in range(self.length(2 if b == 0xdc else 4))]
        if b in (0xde, 0xdf):                        # map 16 / 32
            return self.map(self.length(2 if b == 0xde else 4))
        raise ValueError(f"msgpack format byte 0x{b:02x} is not handled")

    def text(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not handled (only "
                             f"flax's ndarray, type {_EXT_NDARRAY})")
        return _ndarray(data)


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buf = unpackb(data)
    if name == "bfloat16":
        raise ValueError("ndarray dtype 'bfloat16' is not handled (NumPy has "
                         "no bfloat16)")
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"ndarray dtype {name!r} is not handled") from e
    if dtype.hasobject:
        raise ValueError(f"ndarray dtype {name!r} is not handled")
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


def unpackb(data: bytes):
    """The object of one msgpack document (maps as dicts, arrays as
    lists); raises ValueError on trailing bytes."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack document")
    return out


def restore_lists(tree):
    """Maps whose keys are exactly "0" .. "n-1" (n >= 1) turned back into
    lists, as flax stores lists and tuples, recursively."""
    if isinstance(tree, dict):
        tree = {k: restore_lists(v) for k, v in tree.items()}
        if tree and set(tree) == {str(i) for i in range(len(tree))}:
            return [tree[str(i)] for i in range(len(tree))]
    return tree


def load_flax_msgpack(path: str):
    """The pytree of a file written by flax.serialization.to_bytes: numpy
    arrays at the leaves, lists where flax stored lists."""
    with open(path, "rb") as f:
        return restore_lists(unpackb(f.read()))
