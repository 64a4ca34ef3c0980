"""NanoVDB files, port vs reference: the written files are byte for byte
the reference's (a ragged grid, a sparse one, the synthetic shell), each
package decodes them to exactly the same dense grid and majorant, leaves
that overlap or hang over the index box decode as the reference's leaf
loop does, and malformed files are refused."""

import struct

import numpy as np
import pytest

from sienerf_tpu.io import nanovdb as jvdb
from sienerf_torch.io import nanovdb as tvdb


def _grids():
    rng = np.random.default_rng(3)
    ragged = np.zeros((20, 17, 13), np.float32)
    m = rng.random(ragged.shape) < 0.1
    ragged[m] = rng.random(m.sum()).astype(np.float32) * 5
    sparse = np.zeros((24, 24, 24), np.float32)
    sparse[3:6, 17:19, 9:20] = 2.5
    return {"ragged": ragged, "sparse": sparse,
            "shell": tvdb.synthetic_fog_volume(24, "shell").density}


@pytest.mark.parametrize("name", ["ragged", "sparse", "shell"])
def test_files_are_the_reference_bytes_and_decode_alike(tmp_path, name):
    d = _grids()[name]
    jvdb.write_nanovdb(tmp_path / "j.nvdb", d, (0, 0, 0), (2.0, 1.0, 1.5))
    tvdb.write_nanovdb(tmp_path / "t.nvdb", d, (0, 0, 0), (2.0, 1.0, 1.5))
    assert (tmp_path / "t.nvdb").read_bytes() == (tmp_path / "j.nvdb").read_bytes()
    got, want = tvdb.read_nanovdb(tmp_path / "t.nvdb"), jvdb.read_nanovdb(tmp_path / "t.nvdb")
    np.testing.assert_array_equal(got.density, want.density)
    np.testing.assert_array_equal(got.density, d)
    assert got.majorant == want.majorant == float(d.max())
    np.testing.assert_array_equal(got.bbox_min, want.bbox_min)
    np.testing.assert_array_equal(got.bbox_max, want.bbox_max)


def test_overlapping_and_overhanging_leaves(tmp_path):
    """A file whose leaves overlap (max-combined) and one whose index box
    is smaller than its leaves (clipped): the vectorised and the per-leaf
    decodes against the reference."""
    d = _grids()["ragged"]
    tvdb.write_nanovdb(tmp_path / "a.nvdb", d)
    data = bytearray((tmp_path / "a.nvdb").read_bytes())
    meta = list(struct.unpack_from(tvdb._META_FMT, data, 16))
    meta[15:18] = [9, 10, 11]  # shrink the index box's max corner
    struct.pack_into(tvdb._META_FMT, data, 16, *meta)
    (tmp_path / "clip.nvdb").write_bytes(bytes(data))
    got, want = tvdb.read_nanovdb(tmp_path / "clip.nvdb"), jvdb.read_nanovdb(tmp_path / "clip.nvdb")
    assert got.density.shape == (12, 11, 10)
    np.testing.assert_array_equal(got.density, want.density)
    # the second leaf moved onto the first's origin
    leaf0 = 16 + struct.calcsize(tvdb._META_FMT) + len(b"density") + tvdb._GRID_DATA + tvdb._TREE
    data = bytearray((tmp_path / "a.nvdb").read_bytes())
    data[leaf0 + tvdb._LEAF.itemsize:leaf0 + tvdb._LEAF.itemsize + 12] = data[leaf0:leaf0 + 12]
    (tmp_path / "dup.nvdb").write_bytes(bytes(data))
    got, want = tvdb.read_nanovdb(tmp_path / "dup.nvdb"), jvdb.read_nanovdb(tmp_path / "dup.nvdb")
    np.testing.assert_array_equal(got.density, want.density)


def test_synthetic_volumes_match():
    for kind in ("sphere", "shell"):
        got, want = tvdb.synthetic_fog_volume(20, kind), jvdb.synthetic_fog_volume(20, kind)
        np.testing.assert_array_equal(got.density, want.density)
        assert got.majorant == want.majorant
    with pytest.raises(ValueError):
        tvdb.synthetic_fog_volume(8, "torus")


def test_malformed_files_are_refused(tmp_path):
    (tmp_path / "bad.nvdb").write_bytes(b"not a vdb file at all" + b"\x00" * 100)
    with pytest.raises(IOError, match="not a NanoVDB"):
        tvdb.read_nanovdb(tmp_path / "bad.nvdb")
    tvdb.write_nanovdb(tmp_path / "ok.nvdb", _grids()["sparse"])
    data = bytearray((tmp_path / "ok.nvdb").read_bytes())
    struct.pack_into("<H", data, 14, 1)  # a compressed file
    (tmp_path / "zip.nvdb").write_bytes(bytes(data))
    with pytest.raises(IOError, match="compressed"):
        tvdb.read_nanovdb(tmp_path / "zip.nvdb")
