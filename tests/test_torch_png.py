"""The port's PNG decoder (sienerf_torch/io/png.py) against cv2.imread, bit
for bit: PNGs written by cv2 (its adaptive filters) and by a zlib writer
here that sets each row's filter type (None, Sub, Up, Average, Paeth in
turn), at bit depths 1, 2, 4, 8 and 16, in colour types gray, gray +
alpha, RGB, RGBA and palette, with and without tRNS.  cv2 returns BGR
order; the decoder RGB.  Also: an interlaced file raises, load_image of a
PNG equals the JAX package's (which reads through cv2), and write_png
round-trips."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from sienerf_torch.io.png import read_png, write_png


def _chunk(kind, body):
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def _filter_rows(raw: np.ndarray, bpp: int) -> bytes:
    """Rows (H, stride) uint8 -> the filtered stream, row y with filter y % 5."""
    out = []
    prev = np.zeros(raw.shape[1], np.int32)
    for y, row in enumerate(raw.astype(np.int32)):
        f = y % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        b = prev
        if f == 0:
            pred = np.zeros_like(row)
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) // 2
        else:
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png(path, width, height, depth, ctype, raw, bpp, plte=None, trns=None, interlace=0):
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, ctype, 0, 0, interlace))
    if plte is not None:
        data += _chunk(b"PLTE", plte)
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    stream = zlib.compress(_filter_rows(raw, bpp))
    # two IDAT chunks: the decoder joins them
    data += _chunk(b"IDAT", stream[:len(stream) // 2]) + _chunk(b"IDAT", stream[len(stream) // 2:])
    path.write_bytes(data + _chunk(b"IEND", b""))
    return path


def _pack_bits(vals: np.ndarray, depth: int) -> np.ndarray:
    """(H, W) values of `depth` bits -> (H, stride) packed rows."""
    h, w = vals.shape
    bits = ((vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    bits = bits.reshape(h, w * depth)
    pad = (-bits.shape[1]) % 8
    return np.packbits(np.pad(bits, ((0, 0), (0, pad))), axis=1)


def _cv2_rgb(path):
    im = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if im.ndim == 3:
        im = im[..., [2, 1, 0, 3][:im.shape[-1]]]
    return im


def _same(path):
    got, want = read_png(path), _cv2_rgb(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


H, W = 23, 37  # odd sizes: rows of every length, short last bytes


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ctype,spp", [(0, 1), (2, 3), (4, 2), (6, 4)])
def test_every_filter_colour_type_and_depth(tmp_path, depth, ctype, spp):
    rng = np.random.default_rng(depth + ctype)
    top = 255 if depth == 8 else 65535
    vals = rng.integers(0, top + 1, (H, W, spp))
    vals[5:9] = vals[4:5]  # smooth rows: Up and Paeth predict exactly
    raw = vals.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1).view(np.uint8)
    p = _png(tmp_path / "f.png", W, H, depth, ctype, raw, spp * depth // 8)
    got = _same(p)
    assert got.shape[:2] == (H, W)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_bit_gray_is_scaled_to_bytes(tmp_path, depth):
    vals = np.random.default_rng(depth).integers(0, 1 << depth, (H, W))
    got = _same(_png(tmp_path / "g.png", W, H, depth, 0, _pack_bits(vals, depth), 1))
    np.testing.assert_array_equal(got, vals * (255 // ((1 << depth) - 1)))


@pytest.mark.parametrize("depth", [1, 2, 4, 8])
@pytest.mark.parametrize("with_trns", [False, True])
def test_palette_with_and_without_trns(tmp_path, depth, with_trns):
    rng = np.random.default_rng(10 + depth)
    n = 1 << depth
    plte = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    idx = rng.integers(0, n, (H, W))
    trns = bytes(rng.integers(0, 256, max(1, n // 2), dtype=np.uint8)) if with_trns else None
    got = _same(_png(tmp_path / "p.png", W, H, depth, 3, _pack_bits(idx, depth), 1,
                     plte=plte.tobytes(), trns=trns))
    assert got.shape == (H, W, 4 if with_trns else 3)
    np.testing.assert_array_equal(got[..., :3], plte[idx])


@pytest.mark.parametrize("depth", [8, 16])
def test_rgb_key_colour_and_gray_trns(tmp_path, depth):
    rng = np.random.default_rng(20 + depth)
    top = 255 if depth == 8 else 65535
    vals = rng.integers(0, top + 1, (H, W, 3))
    vals[3, :] = vals[0, 0]  # a row of the key colour
    raw = vals.astype(">u2" if depth == 16 else np.uint8).reshape(H, -1).view(np.uint8)
    got = _same(_png(tmp_path / "k.png", W, H, depth, 2, raw, 3 * depth // 8,
                     trns=struct.pack(">HHH", *map(int, vals[0, 0]))))
    assert got.shape == (H, W, 4) and (got[3, :, 3] == 0).all()
    gray = vals[..., 0].astype(">u2" if depth == 16 else np.uint8).view(np.uint8)
    _same(_png(tmp_path / "gt.png", W, H, depth, 0, gray.reshape(H, -1), depth // 8,
               trns=struct.pack(">H", int(vals[0, 0, 0]))))


@pytest.mark.parametrize("shape,dtype", [((H, W), np.uint8), ((H, W), np.uint16),
                                         ((H, W, 3), np.uint8), ((H, W, 3), np.uint16),
                                         ((H, W, 4), np.uint8), ((H, W, 4), np.uint16)])
@pytest.mark.parametrize("level", [1, 9])
def test_files_written_by_cv2(tmp_path, shape, dtype, level):
    rng = np.random.default_rng(level)
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[:, : W // 2] = img[:, :1]  # a smooth half: cv2's filters differ by row
    bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:shape[-1]]]
    cv2.imwrite(str(tmp_path / "c.png"), bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])
    np.testing.assert_array_equal(_same(tmp_path / "c.png"), img)


def test_interlaced_raises(tmp_path):
    raw = np.zeros((H, W), np.uint8)
    p = _png(tmp_path / "i.png", W, H, 8, 0, raw, 1, interlace=1)
    with pytest.raises(NotImplementedError, match="interlaced"):
        read_png(p)


def test_load_image_equals_the_reference(tmp_path):
    from sienerf_tpu.io.image_io import load_image as jload
    from sienerf_torch.io.image_io import load_image

    rng = np.random.default_rng(5)
    for i, shape in enumerate([(H, W, 4), (H, W, 3), (H, W)]):
        for dtype in (np.uint8, np.uint16):
            img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
            bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:shape[-1]]]
            p = tmp_path / f"l{i}{dtype.__name__}.png"
            cv2.imwrite(str(p), bgr)
            for linear in (True, False):
                np.testing.assert_array_equal(load_image(p, as_float_linear=linear),
                                              jload(p, as_float_linear=linear))


@pytest.mark.parametrize("shape,dtype", [((H, W), np.uint8), ((H, W, 3), np.uint16),
                                         ((H, W, 4), np.uint8)])
def test_write_png_round_trips(tmp_path, shape, dtype):
    img = np.random.default_rng(7).integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    img[4:10] = img[3:4]
    write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "w.png"), img)
