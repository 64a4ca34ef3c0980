"""PNG reading and writing without OpenCV: the PNG branch of
io/image_io.py::load_image, which the JAX package reads through
`cv2.imread(path, cv2.IMREAD_UNCHANGED)`, so that PNG datasets load where
cv2 is missing.

`read_png` returns what that call returns, with the colour channels in RGB
order instead of BGR: gray as (H, W); gray + alpha as (H, W, 4) with the
gray value in all three colour channels; RGB as (H, W, 3), or (H, W, 4)
with a `tRNS` key colour (alpha 0 where a pixel equals it, full
elsewhere); RGBA as (H, W, 4); a palette expanded to (H, W, 3), or
(H, W, 4) with `tRNS` alphas.  Bit depths 8 and 16 keep their depth
(uint8, uint16); gray and palette indices of 1, 2 or 4 bits are expanded
(gray scaled to 8 bits).  A gray image's `tRNS` is ignored, as cv2 does.
Interlaced (Adam7) files raise.  The stream is inflated with zlib; the
scanline filters are undone by `csrc/png_unfilter.cpp` (a sequential loop
a row), built with g++ at first use into `sienerf_torch/csrc/build/`.

`write_png` writes 8- or 16-bit gray, RGB or RGBA (`encode_png` gives
the file's bytes), each row with the filter whose output has the least sum
of absolute values (libpng's heuristic, computed for all rows at once)."""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path

import numpy as np

from sienerf_torch.geom.bvh_native import _load

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "png_unfilter.cpp"
_SO = Path(__file__).resolve().parents[1] / "csrc" / "build" / "png_unfilter.so"
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()  # datasets decode on a thread pool


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _load(_SRC, _SO, "png_unfilter", [ctypes.c_void_p, ctypes.c_void_p] +
                        [ctypes.c_int64] * 3)
            lib.png_unfilter.restype = ctypes.c_int64
            _lib = lib
    src = np.frombuffer(data, np.uint8)
    if src.size < height * (stride + 1):
        raise IOError(f"PNG data holds {src.size} bytes, {height * (stride + 1)} expected")
    out = np.empty((height, stride), np.uint8)
    bad = _lib.png_unfilter(src.ctypes.data, out.ctypes.data, height, stride, bpp)
    if bad:
        raise IOError(f"PNG row {bad - 1}: unknown filter type")
    return out


def _unpack_bits(rows: np.ndarray, width: int, depth: int) -> np.ndarray:
    """(H, stride) bytes of `depth`-bit samples -> (H, width) uint8 values."""
    if depth == 8:
        return rows[:, :width]
    bits = np.unpackbits(rows, axis=1).reshape(rows.shape[0], -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=-1).astype(np.uint8)[:, :width]


def read_png(path: str | Path) -> np.ndarray:
    """Decode a PNG file -> the array described in the module docstring."""
    data = Path(path).read_bytes()
    if data[:8] != _SIGNATURE:
        raise IOError(f"failed to load image {path}: not a PNG file")
    pos, idat, plte, trns, hdr = 8, [], None, None, None
    while pos + 8 <= len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise IOError(f"{path}: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise NotImplementedError(f"{path}: interlaced (Adam7) PNG files are not read")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise IOError(f"{path}: colour type {ctype} at bit depth {depth} is not PNG")
    spp = _CHANNELS[ctype]
    stride = (width * spp * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, stride,
                     max(1, spp * depth // 8))
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(height, width, spp)
    else:
        img = _unpack_bits(rows, width * spp, depth).reshape(height, width, spp)
    top = 65535 if depth == 16 else 255
    if ctype == 3:
        if plte is None:
            raise IOError(f"{path}: a palette image without PLTE")
        rgb = plte[np.minimum(img[..., 0], len(plte) - 1)]
        if trns is None:
            return rgb
        alpha = np.full(256, 255, np.uint8)
        alpha[:len(trns)] = np.frombuffer(trns, np.uint8)[:256]
        return np.concatenate([rgb, alpha[img[..., :1]]], axis=-1)
    if ctype == 0:
        g = img[..., 0]
        return g * np.uint8(255 // ((1 << depth) - 1)) if depth < 8 else g
    if ctype == 4:
        return np.concatenate([img[..., :1].repeat(3, axis=-1), img[..., 1:]], axis=-1)
    if ctype == 2 and trns is not None:
        key = np.asarray(struct.unpack(">HHH", trns[:6]), img.dtype)
        alpha = np.where((img == key).all(axis=-1, keepdims=True), 0, top).astype(img.dtype)
        return np.concatenate([img, alpha], axis=-1)
    return img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str | Path, img: np.ndarray, level: int = 6) -> None:
    """Write a (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 or
    uint16 array as a PNG (zlib `level`)."""
    Path(path).write_bytes(encode_png(img, level))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """The bytes of the PNG file write_png writes."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16) or img.ndim not in (2, 3) \
            or (img.ndim == 3 and img.shape[-1] not in (1, 3, 4)):
        raise ValueError(f"write_png takes (H, W[, 1|3|4]) uint8/uint16, got "
                         f"{img.dtype} {img.shape}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    depth = 16 if img.dtype == np.uint16 else 8
    rows = img.astype(">u2" if depth == 16 else np.uint8).reshape(h, -1).view(np.uint8)
    bpp = c * depth // 8
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, cc))
    cand = np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]).astype(np.uint8)
    cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(axis=-1)  # (5, H)
    best = cost.argmin(axis=0)
    filtered = np.concatenate([best.astype(np.uint8)[:, None],
                               cand[best, np.arange(h)]], axis=1)
    ctype = {1: 0, 3: 2, 4: 6}[c]
    return (_SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level)) + _chunk(b"IEND", b""))
