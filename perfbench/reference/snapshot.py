"""The reference's own reader of render-only snapshots (zlib-compressed
MessagePack holding {"state", "meta", ...}; array leaves are maps with
"__ndarray__", "dtype", "shape" and "data").

A frozen copy of the decoding half of the program's MessagePack codec, so
that the reference reads the same raw file as the program without importing
it.  Only the tags the snapshot container uses are decoded.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def take(self, n: int):
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError("truncated msgpack")
        self.pos += n
        return b

    def u(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


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
    raise ValueError(f"msgpack tag 0x{t:02x} is not used by snapshots")


def _tree(node):
    if isinstance(node, dict):
        node = {(k.decode() if isinstance(k, bytes) else k): v for k, v in node.items()}
        if "__ndarray__" in node:
            return np.frombuffer(node["data"], dtype=np.dtype(node["dtype"])) \
                .reshape(node["shape"])
        return {k: _tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree(v) for v in node]
    return node


def read_render_snapshot(path: str | Path) -> dict:
    """A render-only fp8 snapshot -> {"grid_fp8": uint8 (L, T, 8*F) e4m3
    bytes, "grid_scale": f32 (L,) per-level dequantisation scale,
    "density_mlp", "rgb_mlp": lists of f32 (d_in, d_out) matrices,
    "bitfield": bool (K, G, G, G), "grid_shape": (L, T, 8, F)} as numpy."""
    raw = Path(path).read_bytes()
    payload = _unpack_one(_Reader(memoryview(zlib.decompress(raw))))
    state, meta = _tree(payload["state"]), payload["meta"]
    if meta.get("kind") != "render_only_fp8":
        raise ValueError(f"{path}: not a render-only fp8 snapshot ({meta.get('kind')!r})")
    L, T, C, F = (int(x) for x in meta["grid_shape"])
    p = state["params"]
    scale = np.asarray(p["grid_fp8_scale"], np.float32)
    return {
        "grid_fp8": np.asarray(p["grid_fp8"]).reshape(L, T, C * F),
        "grid_scale": np.repeat(scale, L // scale.shape[0]),
        "density_mlp": [np.asarray(w, np.float32) for w in p["density_mlp"]],
        "rgb_mlp": [np.asarray(w, np.float32) for w in p["rgb_mlp"]],
        "bitfield": np.asarray(state["occ"]["bitfield"], bool),
        "grid_shape": (L, T, C, F),
    }
