"""Read the JAX package's `.ckpt` checkpoints (vs_seg_tpu/train/checkpoint.py:
flax `msgpack_serialize` of the state tree) without msgpack or flax.

A small msgpack decoder of its own covers what flax writes: maps, arrays,
str and bin, integers, floats, nil and bool, and flax's extension types
1 (an ndarray: a packed (shape, dtype name, C-order buffer)) and 3 (a numpy
scalar, packed the same way). Arrays that flax split into chunks
(`__msgpack_chunked_array__`, leaves over 1 GiB) are joined again. bfloat16
arrays come back as float32 (numpy has no bfloat16; the conversion is
exact). Arrays come back read-only.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """Decodes one msgpack object at a time from `buf`."""

    def __init__(self, buf: bytes, raw: bool = False):
        self.buf = buf
        self.pos = 0
        # raw: str comes back as bytes (flax reads its ndarray extension's
        # payload with raw=True)
        self.raw = raw

    def _take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def _unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        b = self._take(n)
        return b if self.raw else b.decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack(">b")
        return _ext(code, self._take(n))

    def read(self) -> Any:
        t = self._take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: (">B", self._take), 0xC5: (">H", self._take),
            0xC6: (">I", self._take),
            0xC7: (">B", self._ext), 0xC8: (">H", self._ext),
            0xC9: (">I", self._ext),
            0xD9: (">B", self._str), 0xDA: (">H", self._str),
            0xDB: (">I", self._str),
            0xDC: (">H", self._array), 0xDD: (">I", self._array),
            0xDE: (">H", self._map), 0xDF: (">I", self._map),
        }
        if t in sized:
            fmt, fn = sized[t]
            return fn(self._unpack(fmt))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self._unpack(scalars[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self._ext(fixext[t])
        raise ValueError(f"msgpack type byte 0x{t:02x} is not supported")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack (shape, dtype name, C buffer)."""
    r = _Reader(data, raw=True)
    shape, name, buf = r.read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name))
    return arr.reshape(tuple(shape), order="C")


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack extension type {code} is not supported")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree flax.serialization.msgpack_restore gives for `data`."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(data):
        raise ValueError(f"{len(data) - r.pos} bytes after the msgpack object")
    return _unchunk(tree)


def is_msgpack_map(head: bytes) -> bool:
    """Whether `head` (a file's first byte(s)) starts a msgpack map, as a
    flax state checkpoint does."""
    return bool(head) and (0x80 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF))


def load_jax_checkpoint(path: str) -> dict:
    """A vs_seg_tpu `.ckpt` file -> its state tree (numpy leaves)."""
    with open(path, "rb") as f:
        tree = msgpack_restore(f.read())
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: not a state checkpoint (top level is "
                         f"{type(tree).__name__})")
    return tree
