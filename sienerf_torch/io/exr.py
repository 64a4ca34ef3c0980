"""OpenEXR scanline codec in numpy and zlib (port of the JAX package's
io/exr.py): half / float / uint channels, NONE / ZIPS / ZIP compression,
single-part scanline images, read and written.  A written file is byte for
byte the JAX package's.

The blocks of a file are independent, so their zlib streams are
(de)compressed on a thread pool (zlib releases the interpreter lock): a
4096x4096 half RGBA image is 128 MiB of pixels."""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_MAGIC = 20000630
_PIXELTYPE = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXELTYPE_INV = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1, np.dtype(np.float32): 2}
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16, 4: 32}  # NONE, RLE, ZIPS, ZIP, PIZ


def _pool_map(fn, items: list) -> list:
    if len(items) < 2:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(len(items), os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, items))


def _read_attrs(data: bytes, offset: int):
    attrs = {}
    while True:
        end = data.index(b"\x00", offset)
        name = data[offset:end].decode()
        offset = end + 1
        if not name:
            break
        end = data.index(b"\x00", offset)
        typ = data[offset:end].decode()
        offset = end + 1
        (size,) = struct.unpack_from("<i", data, offset)
        offset += 4
        attrs[name] = (typ, data[offset:offset + size])
        offset += size
    return attrs, offset


def _parse_chlist(raw: bytes):
    channels = []
    off = 0
    while raw[off] != 0:
        end = raw.index(b"\x00", off)
        name = raw[off:end].decode()
        off = end + 1
        ptype, _plin, _xs, _ys = struct.unpack_from("<iiii", raw, off)
        off += 16
        channels.append((name, ptype))
    return channels


def _zip_undo(raw: bytes) -> bytes:
    """Undo EXR's zip pre-processing: the delta predictor, then the
    de-interleave of the two byte halves."""
    t = np.frombuffer(raw, np.uint8).astype(np.int64)
    d = (np.cumsum(np.concatenate([t[:1], t[1:] - 128])) & 0xFF).astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty(len(d), np.uint8)
    out[0::2] = d[:half]
    out[1::2] = d[half:half + len(d) - half]
    return out.tobytes()


def _zip_do(raw: bytes) -> bytes:
    """EXR's zip pre-processing: split even and odd bytes, then delta."""
    d = np.frombuffer(raw, np.uint8)
    half = (len(d) + 1) // 2
    t = np.empty(len(d), np.uint8)
    t[:half] = d[0::2]
    t[half:] = d[1::2]
    ti = t.astype(np.int16)
    delta = np.empty(len(t), np.int16)
    delta[0] = ti[0]
    delta[1:] = ti[1:] - ti[:-1] + 128
    return (delta & 0xFF).astype(np.uint8).tobytes()


def read_exr(path: str | Path) -> dict[str, np.ndarray]:
    """Read a scanline EXR -> {channel name: (H, W) float32}."""
    data = Path(path).read_bytes()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _MAGIC:
        raise IOError(f"{path}: not an EXR file")
    if version & 0x200:
        raise IOError(f"{path}: multi-part EXR not supported")
    if version & 0x800:
        raise IOError(f"{path}: deep EXR not supported")
    attrs, off = _read_attrs(data, 8)
    if "tiles" in attrs:
        raise IOError(f"{path}: tiled EXR not supported")
    channels = _parse_chlist(attrs["channels"][1])
    comp = attrs["compression"][1][0]
    if comp not in (0, 2, 3):
        raise IOError(f"{path}: unsupported compression {comp} (only NONE/ZIPS/ZIP)")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    width, height = x1 - x0 + 1, y1 - y0 + 1
    lpb = _LINES_PER_BLOCK[comp]
    n_blocks = (height + lpb - 1) // lpb
    offsets = struct.unpack_from(f"<{n_blocks}q", data, off)
    dtypes = [np.dtype(_PIXELTYPE[pt]) for _, pt in channels]
    bytes_per_line = sum(dt.itemsize for dt in dtypes) * width

    def decode(o: int):
        y, size = struct.unpack_from("<ii", data, o)
        raw = data[o + 8:o + 8 + size]
        n_lines = min(lpb, y1 - y + 1)
        if comp in (2, 3) and size < bytes_per_line * n_lines:
            raw = _zip_undo(zlib.decompress(raw))  # else stored raw
        return y, n_lines, raw

    out = {name: np.empty((height, width), np.float32) for name, _ in channels}
    for y, n_lines, raw in _pool_map(decode, list(offsets)):
        lines = np.frombuffer(raw, np.uint8, bytes_per_line * n_lines).reshape(
            n_lines, bytes_per_line)
        col = 0
        for (name, _), dt in zip(channels, dtypes):
            n = width * dt.itemsize
            out[name][y - y0:y - y0 + n_lines] = np.ascontiguousarray(
                lines[:, col:col + n]).view(dt).astype(np.float32)
            col += n
    return out


def load_exr_rgba(path: str | Path) -> np.ndarray:
    """(H, W, 4) float32 linear RGBA; a missing colour channel is 0 (or the
    luminance Y), a missing alpha 1."""
    ch = read_exr(path)
    keys = {k.upper(): k for k in ch}
    h, w = next(iter(ch.values())).shape
    out = np.empty((h, w, 4), np.float32)
    for i, name in enumerate("RGB"):
        if name in keys:
            out[..., i] = ch[keys[name]]
        elif "Y" in keys:
            out[..., i] = ch[keys["Y"]]
        else:
            out[..., i] = 0.0
    out[..., 3] = ch[keys["A"]] if "A" in keys else 1.0
    return out


def write_exr(path: str | Path, img: np.ndarray, half: bool = True,
              compress: bool = True) -> None:
    """Write a (H, W, C<=4) float image as a scanline EXR, ZIP (16 lines a
    block) or NONE."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = ["R", "G", "B", "A"][:c] if c > 1 else ["Y"]
    dt = np.dtype(np.float16 if half else np.float32)
    order = sorted(range(c), key=lambda i: names[i])  # channels stored by name
    comp = 3 if compress else 0
    lpb = _LINES_PER_BLOCK[comp]

    def attr(name, typ, val):
        return name.encode() + b"\x00" + typ.encode() + b"\x00" + struct.pack("<i", len(val)) + val

    chlist = b"".join(names[i].encode() + b"\x00" + struct.pack("<iiii", _PIXELTYPE_INV[dt], 0, 1, 1)
                      for i in order) + b"\x00"
    header = b"".join([
        attr("channels", "chlist", chlist),
        attr("compression", "compression", bytes([comp])),
        attr("dataWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1)),
        attr("displayWindow", "box2i", struct.pack("<iiii", 0, 0, w - 1, h - 1)),
        attr("lineOrder", "lineOrder", b"\x00"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
    ]) + b"\x00"

    def encode(y: int) -> bytes:
        # each line holds its channels one after another, in `order`
        raw = np.ascontiguousarray(
            img[y:y + lpb][:, :, order].astype(dt).transpose(0, 2, 1)).tobytes()
        payload = raw
        if comp == 3:
            z = zlib.compress(_zip_do(raw))
            payload = z if len(z) < len(raw) else raw
        return struct.pack("<ii", y, len(payload)) + payload

    blocks = _pool_map(encode, list(range(0, h, lpb)))
    out = bytearray()
    out += struct.pack("<ii", _MAGIC, 2)
    out += header
    table_pos = len(out)
    out += b"\x00" * (8 * len(blocks))
    offsets = []
    for b in blocks:
        offsets.append(len(out))
        out += b
    struct.pack_into(f"<{len(blocks)}q", out, table_pos, *offsets)
    Path(path).write_bytes(bytes(out))
