"""Minimal MessagePack codec with no external dependency (port of the JAX
package's io/msgpack_lite.py).  Covers nil/bool/ints/floats/str/bin/array/
map, the subset nlohmann::json's to_msgpack emits, which the reference's
snapshot files use; ext payloads decode to raw bytes.

The encoder writes the smallest format for each value, floats as float64
and numpy arrays as their raw bytes, byte for byte as the JAX package's
encoder does.  Map keys that are bytes are written as bin (the snapshot
container keys its array leaves so); any other key as the str of it.
"""

from __future__ import annotations

import struct

import numpy as np


def pack(obj) -> bytes:
    out = bytearray()
    _pack_into(obj, out)
    return bytes(out)


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int, tags) -> None:
    """The header of a str/bin/array/map of length n: a fix form when
    `fix` is given and n fits it, else the first of the 8/16/32-bit tags
    (None where the family has no such form) whose length field holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for tag, fmt, lim in zip(tags, (">BB", ">BH", ">BI"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= lim:
            out += struct.pack(fmt, tag, n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(obj: int, out: bytearray) -> None:
    if 0 <= obj <= 0x7F:
        out.append(obj)
    elif -32 <= obj < 0:
        out.append(obj & 0xFF)
    elif obj >= 0:
        for tag, fmt, lim in ((0xCC, ">BB", 0xFF), (0xCD, ">BH", 0xFFFF),
                              (0xCE, ">BI", 0xFFFFFFFF), (0xCF, ">BQ", (1 << 64) - 1)):
            if obj <= lim:
                out += struct.pack(fmt, tag, obj)
                return
        raise ValueError(f"msgpack: int {obj} too large")
    else:
        for tag, fmt, lim in ((0xD0, ">Bb", 1 << 7), (0xD1, ">Bh", 1 << 15),
                              (0xD2, ">Bi", 1 << 31), (0xD3, ">Bq", 1 << 63)):
            if obj >= -lim:
                out += struct.pack(fmt, tag, obj)
                return
        raise ValueError(f"msgpack: int {obj} too small")


def _pack_into(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(out, len(b), None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack_into(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack_into(k if isinstance(k, bytes) else str(k), out)
            _pack_into(v, out)
    elif isinstance(obj, np.integer):
        _pack_into(int(obj), out)
    elif isinstance(obj, np.floating):
        _pack_into(float(obj), out)
    elif isinstance(obj, np.ndarray):
        _pack_into(obj.tobytes(), out)
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated msgpack")
        self.pos += n
        return b

    def u(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def unpack(buf: bytes):
    return _unpack_one(_Reader(memoryview(buf)))


_FIXED = {
    0xC0: lambda r: None, 0xC2: lambda r: False, 0xC3: lambda r: True,
    0xC4: lambda r: bytes(r.take(r.u(">B"))),
    0xC5: lambda r: bytes(r.take(r.u(">H"))),
    0xC6: lambda r: bytes(r.take(r.u(">I"))),
    0xCA: lambda r: r.u(">f"), 0xCB: lambda r: r.u(">d"),
    0xCC: lambda r: r.u(">B"), 0xCD: lambda r: r.u(">H"),
    0xCE: lambda r: r.u(">I"), 0xCF: lambda r: r.u(">Q"),
    0xD0: lambda r: r.u(">b"), 0xD1: lambda r: r.u(">h"),
    0xD2: lambda r: r.u(">i"), 0xD3: lambda r: r.u(">q"),
    0xD9: lambda r: bytes(r.take(r.u(">B"))).decode("utf-8"),
    0xDA: lambda r: bytes(r.take(r.u(">H"))).decode("utf-8"),
    0xDB: lambda r: bytes(r.take(r.u(">I"))).decode("utf-8"),
    0xDC: lambda r: [_unpack_one(r) for _ in range(r.u(">H"))],
    0xDD: lambda r: [_unpack_one(r) for _ in range(r.u(">I"))],
    0xDE: lambda r: {_unpack_one(r): _unpack_one(r) for _ in range(r.u(">H"))},
    0xDF: lambda r: {_unpack_one(r): _unpack_one(r) for _ in range(r.u(">I"))},
}


def _unpack_one(r: _Reader):
    t = r.u(">B")
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0x80 <= t <= 0x8F:
        return {_unpack_one(r): _unpack_one(r) for _ in range(t & 0xF)}
    if 0x90 <= t <= 0x9F:
        return [_unpack_one(r) for _ in range(t & 0xF)]
    if 0xA0 <= t <= 0xBF:
        return bytes(r.take(t & 0x1F)).decode("utf-8")
    if t in _FIXED:
        return _FIXED[t](r)
    if 0xD4 <= t <= 0xD8 or t in (0xC7, 0xC8, 0xC9):
        # ext types: skip the type byte, return the payload raw
        n = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}.get(t)
        n = r.u(n) if n else 1 << (t - 0xD4)
        r.take(1)
        return bytes(r.take(n))
    raise ValueError(f"unknown msgpack tag 0x{t:02x}")


def top_keys(buf: bytes):
    """The keys of the map that `buf` begins with, in order, as far as the
    buffer holds them (each value is decoded to reach the next key; a value
    the buffer cuts off ends the walk)."""
    r = _Reader(memoryview(buf))
    try:
        t = r.u(">B")
        if 0x80 <= t <= 0x8F:
            n = t & 0xF
        elif t in (0xDE, 0xDF):
            n = r.u(">H" if t == 0xDE else ">I")
        else:
            return
        for _ in range(n):
            key = _unpack_one(r)
            yield key
            _unpack_one(r)
    except ValueError:  # the buffer ends inside a value
        return
