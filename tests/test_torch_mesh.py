"""Mesh files and the meshes built in code, port vs reference: OBJ (with
texture / normal indices, negative indices, polygons), binary and ASCII
STL, normalisation to the unit cube, triangle normals and areas, and OBJ /
PLY writing.  The reference's meshes live outside the repo, so every mesh
here is built in code (geom/mesh_io.py::icosphere, box_mesh).

Tolerances: none; the port is the same numpy code and must give the same
arrays and bytes."""

import struct

import numpy as np
import pytest

from sienerf_tpu.geom import mesh_io as jm
from sienerf_torch.geom import mesh_io as tm


def _tris(seed=0, n=50):
    return np.random.default_rng(seed).standard_normal((n, 3, 3)).astype(np.float32)


def test_obj_reader(tmp_path):
    p = tmp_path / "m.obj"
    p.write_text("# a comment\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\n"
                 "f 1/1/1 2/1/1 3/1/1 4/1/1\nf -4 -3 -1\nusemtl x\n")
    got = tm.load_obj(p)
    np.testing.assert_array_equal(got, jm.load_obj(p))
    assert got.shape == (3, 3, 3)


@pytest.mark.parametrize("ascii_", [False, True])
def test_stl_reader(tmp_path, ascii_):
    tri = _tris(1, 7)
    p = tmp_path / "m.stl"
    if ascii_:
        lines = ["solid x"]
        for t in tri:
            lines += ["facet normal 0 0 1", "outer loop"]
            lines += [f"vertex {v[0]!r} {v[1]!r} {v[2]!r}" for v in t.tolist()]
            lines += ["endloop", "endfacet"]
        p.write_text("\n".join(lines + ["endsolid x"]))
    else:
        body = b"".join(struct.pack("<12fH", *([0, 0, 1] + t.reshape(-1).tolist()), 0)
                        for t in tri)
        p.write_bytes(b"\0" * 80 + struct.pack("<I", len(tri)) + body)
    got = tm.load_mesh(p)
    np.testing.assert_array_equal(got, jm.load_mesh(p))
    np.testing.assert_allclose(got, tri, rtol=1e-6)
    with pytest.raises(ValueError):
        tm.load_mesh(tmp_path / "m.ply")


@pytest.mark.parametrize("center,margin", [(None, 1.0), ((0.2, -1.0, 3.0), 0.9)])
def test_normalise_normals_areas(center, margin):
    tri = _tris(2) * 3.0 + 5.0
    np.testing.assert_array_equal(tm.normalize_to_unit_cube(tri, center, margin),
                                  jm.normalize_to_unit_cube(tri, center, margin))
    np.testing.assert_array_equal(tm.triangle_normals(tri), jm.triangle_normals(tri))
    np.testing.assert_array_equal(tm.triangle_areas(tri), jm.triangle_areas(tri))


@pytest.mark.parametrize("colors,normals", [(False, False), (True, False), (True, True),
                                            (False, True)])
def test_obj_and_ply_writers(tmp_path, colors, normals):
    rng = np.random.default_rng(3)
    v = rng.random((9, 3)).astype(np.float32)
    f = rng.integers(0, 9, (5, 3))
    c = rng.random((9, 3)).astype(np.float32) if colors else None
    n = rng.standard_normal((9, 3)).astype(np.float32) if normals else None
    for name in ("save_obj", "save_ply"):
        getattr(tm, name)(tmp_path / "a", v, f, c, n)
        getattr(jm, name)(tmp_path / "b", v, f, c, n)
        assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes(), name


@pytest.mark.parametrize("sub", [0, 1, 3])
def test_icosphere_is_a_closed_outward_sphere(sub):
    tri = tm.icosphere(sub, radius=2.0)
    assert tri.shape == (20 * 4 ** sub, 3, 3) and tri.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(tri, axis=-1), 2.0, rtol=1e-6)
    normals = tm.triangle_normals(tri)
    assert (np.sum(normals * tri.mean(axis=1), axis=-1) > 0).all()
    # closed: every edge is shared by two triangles, once each way
    edges = {}
    for t in np.round(tri, 5):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = (tuple(t[a]), tuple(t[b]))
            edges[key] = edges.get(key, 0) + 1
    assert all(edges.get((b, a)) == 1 for (a, b) in edges)
    # inscribed in the sphere: the area grows towards 4 pi r^2 (an
    # icosahedron has 76 % of it)
    area = tm.triangle_areas(tri).sum()
    assert 0.75 * 16 * np.pi < area < 16 * np.pi


def test_box_mesh(tmp_path):
    box = tm.box_mesh((0.1, 0.2, 0.3), (0.6, 0.9, 0.4))
    assert box.shape == (12, 3, 3)
    assert tm.triangle_areas(box).sum() == pytest.approx(2 * (0.5 * 0.7 + 0.5 * 0.1 + 0.7 * 0.1),
                                                         rel=1e-5)
    centre = np.asarray([0.35, 0.55, 0.35])
    assert (np.sum(tm.triangle_normals(box) * (box.mean(axis=1) - centre), axis=-1) > 0).all()
    tm.save_obj(tmp_path / "box.obj", box.reshape(-1, 3), np.arange(36).reshape(-1, 3))
    np.testing.assert_allclose(jm.load_obj(tmp_path / "box.obj"), box, rtol=1e-6)
