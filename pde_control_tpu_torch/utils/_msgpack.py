"""A small msgpack codec for flax's parameter files.

Encodes and decodes the subset of msgpack that
`flax.serialization.to_bytes` writes for a parameter tree: maps with str
keys, str, bin, ints, floats, nil and booleans, arrays, and the ext types
1 (an ndarray: msgpack of `[shape, dtype name, C-order bytes]`) and 3 (a
numpy scalar, the same payload). Dict keys are written in sorted order, as
`jax.device_get` leaves a parameter tree, so that a tree's bytes are the
ones flax writes for it. Arrays flax splits into chunks (above 2**30
bytes) are not read.
"""

from __future__ import annotations

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, lim in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)
    else:
        for code, fmt, lim in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                               (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -lim:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(v)


def _pack_len(n: int, fix: int | None, fixmax: int, codes, out: bytearray):
    if fix is not None and n < fixmax:
        out.append(fix | n)
        return
    for code, fmt, lim in codes:
        if n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(n)


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, None, 0, ((0xc7, ">B", 1 << 8), (0xc8, ">H", 1 << 16),
                               (0xc9, ">I", 1 << 32)), out)
    out += struct.pack(">b", code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True:
        out.append(0xc3)
    elif obj is False:
        out.append(0xc2)
    elif isinstance(obj, np.ndarray):
        _pack_ext(EXT_NDARRAY, _ndarray_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xa0, 32, ((0xd9, ">B", 1 << 8),
                                        (0xda, ">H", 1 << 16),
                                        (0xdb, ">I", 1 << 32)), out)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, ((0xc4, ">B", 1 << 8),
                                      (0xc5, ">H", 1 << 16),
                                      (0xc6, ">I", 1 << 32)), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, ((0xdc, ">H", 1 << 16),
                                       (0xdd, ">I", 1 << 32)), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, ((0xde, ">H", 1 << 16),
                                       (0xdf, ">I", 1 << 32)), out)
        for key in sorted(obj):
            if not isinstance(key, str):
                raise TypeError(f"map keys must be str, got {key!r}")
            _pack(key, out)
            _pack(obj[key], out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # code: (kind, length format)
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _ext(code: int, data: bytes):
    if code in (EXT_NDARRAY, EXT_NPSCALAR):
        shape, dtype, buf = unpackb(data)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr
    raise ValueError(f"unsupported msgpack ext type {code}")


def _read(r: _Reader):
    c = r.take(1)[0]
    if c < 0x80:
        return c
    if c >= 0xe0:
        return c - 0x100
    if 0x80 <= c <= 0x8f:
        return _read_map(r, c & 0x0f)
    if 0x90 <= c <= 0x9f:
        return [_read(r) for _ in range(c & 0x0f)]
    if 0xa0 <= c <= 0xbf:
        return r.take(c & 0x1f).decode("utf-8")
    if c == 0xc0:
        return None
    if c in (0xc2, 0xc3):
        return c == 0xc3
    if c in _NUMBERS:
        return r.unpack(_NUMBERS[c])
    if c in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[c]))
    if c in _SIZED:
        kind, fmt = _SIZED[c]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return r.take(n).decode("utf-8")
        if kind == "array":
            return [_read(r) for _ in range(n)]
        if kind == "map":
            return _read_map(r, n)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"unsupported msgpack byte 0x{c:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r)
        out[key] = _read(r)
    return out


def unpackb(data: bytes):
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return out
