"""The EXR codec and the EXR branches of load_image / save_image, port vs
reference: the files written are byte for byte the reference's (half and
float, ZIP and NONE, 1 to 4 channels, a height that is not a multiple of
a ZIP block, incompressible noise that ZIP stores raw), and each package
decodes the other's files to exactly the same arrays."""

import struct
import zlib

import numpy as np
import pytest

from sienerf_tpu.io import exr as jexr
from sienerf_tpu.io.image_io import load_image as jload
from sienerf_torch.io import exr as texr
from sienerf_torch.io.image_io import load_image, save_image


def _image(h, w, c, seed, noise=False):
    rng = np.random.default_rng(seed)
    if noise:
        return rng.normal(0, 100, (h, w, c)).astype(np.float32)
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    img = np.stack([np.sin(40 * (x * x + y * y)) * (1 + k) for k in range(c)], -1)
    return (img + rng.normal(0, 1e-3, img.shape)).astype(np.float32)


CASES = [(37, 29, 4, True, True, False), (37, 29, 3, False, True, False),
         (16, 8, 1, True, False, False), (20, 11, 2, False, False, False),
         (40, 24, 4, True, True, True)]


@pytest.mark.parametrize("h,w,c,half,compress,noise", CASES)
def test_written_files_are_the_reference_bytes(tmp_path, h, w, c, half, compress, noise):
    img = _image(h, w, c, h * w, noise)
    jexr.write_exr(tmp_path / "j.exr", img, half=half, compress=compress)
    texr.write_exr(tmp_path / "t.exr", img, half=half, compress=compress)
    assert (tmp_path / "t.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()


@pytest.mark.parametrize("h,w,c,half,compress,noise", CASES)
def test_each_reads_the_others_files_exactly(tmp_path, h, w, c, half, compress, noise):
    img = _image(h, w, c, h + w, noise)
    jexr.write_exr(tmp_path / "j.exr", img, half=half, compress=compress)
    texr.write_exr(tmp_path / "t.exr", img, half=half, compress=compress)
    for f in ("j.exr", "t.exr"):
        got, want = texr.read_exr(tmp_path / f), jexr.read_exr(tmp_path / f)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(texr.load_exr_rgba(tmp_path / f),
                                      jexr.load_exr_rgba(tmp_path / f))
    dt = np.float16 if half else np.float32
    rgba = texr.load_exr_rgba(tmp_path / "t.exr")
    want = img.astype(dt).astype(np.float32)
    if c > 1:
        np.testing.assert_array_equal(rgba[..., :c], want)
    else:
        np.testing.assert_array_equal(rgba[..., 0], want[..., 0])


def test_zips_blocks_of_one_line_read(tmp_path):
    """A ZIPS file (one line a block, compression 2), which neither writer
    makes: the header of a NONE file with its lines zipped one by one."""
    img = _image(9, 13, 4, 5)
    texr.write_exr(tmp_path / "n.exr", img, compress=False)
    data = bytearray((tmp_path / "n.exr").read_bytes())
    at = data.index(b"compression\x00compression\x00") + len(b"compression\x00compression\x00") + 4
    data[at] = 2
    n_blocks = 9
    table = texr._read_attrs(bytes(data), 8)[1]
    offsets = struct.unpack_from(f"<{n_blocks}q", data, table)
    out = bytes(data[:table + 8 * n_blocks])
    new_offsets = []
    for o in offsets:
        y, size = struct.unpack_from("<ii", data, o)
        z = zlib.compress(texr._zip_do(bytes(data[o + 8:o + 8 + size])))
        new_offsets.append(len(out))
        out += struct.pack("<ii", y, len(z)) + z
    out = bytearray(out)
    struct.pack_into(f"<{n_blocks}q", out, table, *new_offsets)
    (tmp_path / "z.exr").write_bytes(bytes(out))
    np.testing.assert_array_equal(texr.load_exr_rgba(tmp_path / "z.exr"),
                                  jexr.load_exr_rgba(tmp_path / "z.exr"))
    np.testing.assert_array_equal(texr.load_exr_rgba(tmp_path / "z.exr"),
                                  img.astype(np.float16).astype(np.float32))


def test_load_and_save_image(tmp_path):
    img = _image(21, 17, 4, 3)
    save_image(tmp_path / "s.exr", img)
    jexr.write_exr(tmp_path / "j.exr", img)
    assert (tmp_path / "s.exr").read_bytes() == (tmp_path / "j.exr").read_bytes()
    np.testing.assert_array_equal(load_image(tmp_path / "s.exr"), jload(tmp_path / "s.exr"))
    # LDR saving (ported since): the PNG pixels of the JAX package's cv2 write
    import cv2

    from sienerf_tpu.io.image_io import save_image as jsave

    save_image(tmp_path / "s.png", img)
    jsave(tmp_path / "j.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "s.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED))


def test_refuses_what_it_cannot_read(tmp_path):
    (tmp_path / "bad.exr").write_bytes(b"\x00" * 64)
    with pytest.raises(IOError, match="not an EXR"):
        texr.read_exr(tmp_path / "bad.exr")
    img = _image(8, 8, 3, 1)
    texr.write_exr(tmp_path / "ok.exr", img)
    data = bytearray((tmp_path / "ok.exr").read_bytes())
    data[4:8] = struct.pack("<i", 2 | 0x200)
    (tmp_path / "multi.exr").write_bytes(bytes(data))
    with pytest.raises(IOError, match="multi-part"):
        texr.read_exr(tmp_path / "multi.exr")
