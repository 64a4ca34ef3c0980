"""The port's triangle octree (sienerf_torch/geom/octree.py, a copy of the
JAX package's host numpy build with its SAT test on a thread pool) against
the JAX package's, equal: depth, node and vertex counts, every level's
sorted cell codes and corner-vertex ids, at depths 4-7 on meshes built in
code (an icosphere, a box, the two together; a mesh outside the unit cube,
on which the build stops at depth 1), and the device tables as int32
tensors with the JAX package's overflow check."""

import numpy as np
import pytest
import torch

from sienerf_tpu.geom import octree as jo
from sienerf_torch.geom import octree as to
from sienerf_torch.geom.mesh_io import box_mesh, icosphere


def _meshes():
    sphere = icosphere(2, 0.3) + 0.5
    box = box_mesh((0.62, 0.15, 0.7), (0.9, 0.45, 0.93))
    tilted = icosphere(1, 0.2) * np.asarray([1.0, 0.4, 1.3]) + np.asarray([0.3, 0.6, 0.45])
    return {"sphere": sphere, "box": box, "both": np.concatenate([sphere, box]),
            "tilted": tilted, "outside": icosphere(1, 0.2) + 2.0}


MESHES = _meshes()


def _assert_equal(a, b):
    assert (a.depth, a.n_nodes, a.n_vertices) == (b.depth, b.n_nodes, b.n_vertices)
    assert len(a.codes) == len(b.codes) == len(a.verts) == len(b.verts) == a.depth
    for d in range(a.depth):
        np.testing.assert_array_equal(a.codes[d], b.codes[d])
        np.testing.assert_array_equal(a.verts[d], b.verts[d])
        np.testing.assert_array_equal(a.level_cells(d), b.level_cells(d))


@pytest.mark.parametrize("depth", [4, 5, 6, 7])
@pytest.mark.parametrize("name", ["sphere", "box", "both", "tilted"])
def test_build_equals_the_reference(name, depth):
    tris = MESHES[name].astype(np.float32)
    a = to.build_triangle_octree(tris, depth)
    b = jo.build_triangle_octree(tris, depth)
    _assert_equal(a, b)
    assert a.depth == depth and a.n_nodes > depth


def test_a_mesh_outside_the_cube_stops_the_build_early():
    a = to.build_triangle_octree(MESHES["outside"], 6)
    _assert_equal(a, jo.build_triangle_octree(MESHES["outside"], 6))
    assert a.depth == 1 and a.n_nodes == 1 and a.n_vertices == 8


def test_threaded_sat_equals_one_call(monkeypatch):
    """The SAT over chunks on a thread pool gives the one-call result."""
    rng = np.random.default_rng(0)
    tris = rng.random((5000, 3, 3))
    centers = rng.random((5000, 3))
    want = jo._tri_box_overlap(tris, centers, 0.05)
    monkeypatch.setattr(to, "_SAT_CHUNK", 777)
    np.testing.assert_array_equal(to._tri_box_overlap_threads(tris, centers, 0.05), want)
    assert 0 < want.sum() < len(want)


def test_device_tables():
    tree = to.build_triangle_octree(MESHES["both"], 5)
    tables = to.octree_device_tables(tree, "cpu")
    want = jo.octree_device_tables(jo.build_triangle_octree(MESHES["both"], 5))
    assert sorted(tables) == sorted(want)
    for k, v in tables.items():
        assert v.dtype == torch.int32
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    deep = to.TriangleOctree(depth=12, n_vertices=8, n_nodes=1,
                             codes=[np.asarray([1 << 33])] * 12, verts=[np.zeros((1, 8))] * 12)
    with pytest.raises(ValueError, match="overflow"):
        to.octree_device_tables(deep)
