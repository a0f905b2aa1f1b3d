"""Read the bytes ``flax.serialization.to_bytes`` writes, with no ``msgpack``
or ``flax`` package: a ``weights.msgpack`` artifact of a repository version
dir (the JAX package's native weight format).

flax writes a state dict as msgpack (https://github.com/msgpack/msgpack/
blob/master/spec.md): nested maps with string keys, every array leaf an
ext record of type 1 whose data is itself msgpack, ``(shape, dtype name,
C-order bytes)``; type 3 is a numpy scalar in the same form, type 2 a
complex ``(real, imag)``. An array above 2**30 bytes is split into a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
of flat pieces, which :func:`read_flax_msgpack` joins again. A ``bfloat16``
leaf comes back as ``config.BF16`` words. The output is a nested dict of
numpy arrays, the flax tree that ``models/convert.py`` carries onto a
model.
"""

from __future__ import annotations

import pathlib
import struct

import numpy as np

from triton_client_tpu_torch.config import BF16

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """One msgpack document over a buffer; ``raw`` leaves str as bytes."""

    def __init__(self, buf, raw: bool = False) -> None:
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack(">" + "BHI"[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} begins no value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Reader(data).value()
            return complex(real, imag)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(data) -> np.ndarray:
    """flax's ndarray ext data -> array (a copy: the caller may write it)."""
    reader = _Reader(data, raw=True)
    shape, name, buffer = reader.value()
    name = name.decode() if isinstance(name, bytes) else name
    dtype = BF16 if name == "bfloat16" else np.dtype(name)
    return np.frombuffer(buffer, dtype=dtype).reshape(tuple(shape)).copy()


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_flax_msgpack(path_or_bytes) -> dict:
    """A ``flax.serialization.to_bytes`` document (a path or the bytes) ->
    the state dict it holds: nested dicts of numpy arrays."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        blob = path_or_bytes
    else:
        blob = pathlib.Path(path_or_bytes).read_bytes()
    reader = _Reader(blob)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the document")
    return _unchunk(tree)
