"""Pure-Python reader and writer of flax msgpack checkpoints.

The JAX package saves its ``TrainState`` with ``flax.serialization.to_bytes``
(vi/train.py:634-656): a msgpack map whose array leaves are msgpack ext
objects of type 1, each holding a packed ``(shape, dtype name, raw bytes)``
triple.  This module decodes that subset of msgpack (maps, arrays, str, bin,
int, float, bool, nil, ext type 1) into dicts, lists and numpy arrays, so the
port reads such checkpoints without flax or msgpack: the counterpart of
``flax.serialization.msgpack_restore`` as ``Trainer.restore`` uses it
(train.py:686).  Anything else raises.  ``msgpack_serialize`` writes such a
tree back the way ``flax.serialization.msgpack_serialize`` does (the
encoding msgpack-python picks for each value, insertion-ordered maps, every
array as an ext-1 leaf), so the JAX package's ``Trainer.restore`` reads a
checkpoint the port wrote.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Tuple:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))

    def read(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self.read_map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return self.read_str(tag & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            (n,) = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[tag])
            return bytes(self.take(n))
        if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            (n,) = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[tag])
            (code,) = self.unpack(">b")
            return self.read_ext(code, bytes(self.take(n)))
        if 0xD4 <= tag <= 0xD8:  # fixext 1/2/4/8/16
            (code,) = self.unpack(">b")
            return self.read_ext(code, bytes(self.take(1 << (tag - 0xD4))))
        ints = {
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
            0xCA: ">f", 0xCB: ">d",
        }
        if tag in ints:
            return self.unpack(ints[tag])[0]
        if tag in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            (n,) = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[tag])
            return self.read_str(n)
        if tag in (0xDC, 0xDD):  # array 16/32
            (n,) = self.unpack(">H" if tag == 0xDC else ">I")
            return [self.read() for _ in range(n)]
        if tag in (0xDE, 0xDF):  # map 16/32
            (n,) = self.unpack(">H" if tag == 0xDE else ">I")
            return self.read_map(n)
        raise ValueError(f"unsupported msgpack type byte 0x{tag:02x}")

    def read_str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def read_map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("chunked flax arrays (> 1 GiB leaves) are not supported")
        return out

    def read_ext(self, code: int, payload: bytes) -> np.ndarray:
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(payload)
        triple = inner.read()
        if inner.pos != len(payload) or not (isinstance(triple, list) and len(triple) == 3):
            raise ValueError("malformed flax ndarray payload")
        shape, dtype_name, buf = triple
        if isinstance(dtype_name, bytes):
            dtype_name = dtype_name.decode("ascii")
        if dtype_name == "bfloat16":
            raise ValueError("bfloat16 leaves are not supported")
        return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode flax msgpack bytes into a tree of dicts, lists and numpy arrays."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} trailing bytes after the msgpack object")
    return tree


def load_checkpoint(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, tags: Tuple[int, ...]) -> None:
    """Header of a str/bin/array/map: fix form up to ``fix_max``, then 8/16/32-bit lengths."""
    if fix and n <= fix_max:
        out.append(fix | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} too large")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
        return
    forms = ((0xCC, ">B", 0, 0xFF), (0xCD, ">H", 0, 0xFFFF), (0xCE, ">I", 0, 0xFFFFFFFF),
             (0xCF, ">Q", 0, 2**64 - 1)) if x >= 0 else (
             (0xD0, ">b", -(2**7), 0), (0xD1, ">h", -(2**15), 0), (0xD2, ">i", -(2**31), 0),
             (0xD3, ">q", -(2**63), 0))
    for tag, fmt, lo, hi in forms:
        if lo <= x <= hi:
            out.append(tag)
            out += struct.pack(fmt, x)
            return
    raise ValueError(f"integer {x} out of msgpack range")


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        raw = x.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(x, (bytes, bytearray)):
        _pack_len(out, len(x), 0, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        if x.nbytes > 2**30:
            raise ValueError("chunked flax arrays (> 1 GiB leaves) are not supported")
        inner = bytearray()
        _pack(inner, [[int(d) for d in x.shape], x.dtype.name, np.ascontiguousarray(x).tobytes()])
        n = len(inner)
        if n in (1, 2, 4, 8, 16):  # fixext
            out.append(0xD4 + n.bit_length() - 1)
        else:
            _pack_len(out, n, 0, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += inner
    else:
        raise TypeError(f"cannot serialise {type(x).__name__} as flax msgpack")


def msgpack_serialize(tree: Any) -> bytes:
    """Encode a tree of dicts, lists and numpy arrays as flax msgpack bytes."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


def save_checkpoint(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path`` atomically: a temp file, fsync, then rename,
    so a process killed mid-write never leaves a truncated checkpoint
    (train.py:634-653)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack_serialize(tree))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
