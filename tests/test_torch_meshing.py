"""Meshes of a field, port vs reference: the generated marching-cubes
table, marching cubes and surface nets on the same grids (identical
vertex and face arrays), the field on the grid, the 1-ring sums, vertex
refinement by Adam (optimise_mesh), and Session.save_mesh /
optimise_mesh_step on the fox field (density 2.5, vertex colours) and on
a fitted SDF (the zero level).

Tolerances: the table, vertices and faces exact (the same numpy code);
grids of an analytic field rtol 1e-6; 1-ring sums rtol 1e-5 / atol 1e-6
(sums in another order); refined vertices rtol 1e-5 / atol 1e-6 (Adam of
the same f32 terms; the bias corrections' f32 pow runs in another
library); the fox's density grid and vertex colours at the MLP bound
(rtol 1e-2 / atol 1e-3; densities on the raw, pre-exp outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.ops import marching_cubes as jmc
from sienerf_tpu.ops import meshing as jmesh
from sienerf_torch.ops import marching_cubes as tmc
from sienerf_torch.ops import meshing as tmesh

MLP_TOL = dict(rtol=1e-2, atol=1e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _blobs(p, lib):
    """Two overlapping balls and a slab: a density in the unit cube."""
    def ball(c, r):
        q = p - c
        return r - lib.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2])
    a = ball(lib.asarray([0.4, 0.45, 0.5]) if lib is jnp else torch.tensor([0.4, 0.45, 0.5]),
             0.22)
    b = ball(lib.asarray([0.62, 0.55, 0.48]) if lib is jnp else torch.tensor([0.62, 0.55, 0.48]),
             0.17)
    return 20.0 * lib.maximum(a, b)


def test_table_and_extractors_match():
    np.testing.assert_array_equal(tmc.TRI_TABLE, jmc.TRI_TABLE)
    r = 28
    want = jmesh.density_on_grid(lambda u: _blobs(u, jnp), r, None, None)
    grid = tmesh.density_on_grid(lambda u: _blobs(u, torch), r, "cpu", chunk=1000)
    np.testing.assert_allclose(grid, want, rtol=1e-6, atol=1e-6)
    noisy = grid + np.random.default_rng(0).normal(0, 0.3, grid.shape).astype(np.float32)
    amin, adiag = np.asarray([-0.5, 0.0, 0.25], np.float32), np.asarray([2.0, 1.0, 0.5])
    for g in (grid, noisy):
        for iso in (0.0, 1.5):
            tv, tf = tmc.marching_cubes(g, iso, amin, adiag)
            jv, jf = jmc.marching_cubes(g, iso, amin, adiag)
            np.testing.assert_array_equal(tv, jv)
            np.testing.assert_array_equal(tf, jf)
            sv, sf = tmesh.surface_nets(g, iso, amin, adiag)
            jv, jf = jmesh.surface_nets(g, iso, amin, adiag)
            np.testing.assert_array_equal(sv, jv)
            np.testing.assert_array_equal(sf, jf)
    assert len(tf) > 100
    # a closed surface: every edge is shared by exactly two triangles
    v, f = tmc.marching_cubes(grid, 0.0, amin, adiag)
    edges = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    empty = tmc.marching_cubes(np.ones((8, 8, 8), np.float32), 0.0, amin, adiag)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def _mesh():
    g = tmesh.density_on_grid(lambda u: _blobs(u, torch), 20, "cpu")
    return tmc.marching_cubes(g, 2.5, np.zeros(3, np.float32), np.ones(3, np.float32))


def test_one_ring_and_refinement_match():
    v, f = _mesh()
    jc, jn = jmesh.mesh_1ring(v, f)
    tc, tn = tmesh.mesh_1ring(torch.from_numpy(v), torch.from_numpy(f))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-5, atol=1e-6)
    amin, adiag = np.zeros(3, np.float32), np.ones(3, np.float32)
    want = jmesh.optimise_mesh(lambda u: _blobs(u, jnp), v, f, amin, adiag, n_steps=3)
    got = tmesh.optimise_mesh(lambda u: _blobs(u, torch), v, f, amin, adiag, "cpu", n_steps=3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(got - v).max() > 1e-5


def test_fox_mesh_with_colours(tmp_path):
    from sienerf_torch.geom.mesh_io import load_obj
    from test_torch_snapshot import fox_jax, fox_port_session

    from sienerf_tpu.models.nerf_network import apply_rgb_activation, nerf_apply
    from sienerf_tpu.models.nerf_network import density_raw as jdensity_raw
    from sienerf_torch.models.nerf_network import density_raw

    jeng, jparams, _ = fox_jax()
    s = fox_port_session()
    r = 24
    want = jmesh.density_on_grid(lambda u: jdensity_raw(jeng.net, jparams, u), r, None, None)
    got = tmesh.density_on_grid(lambda u: density_raw(s.engine.net, s.render_params(), u), r,
                                "cpu")
    np.testing.assert_allclose(got, want, **MLP_TOL)
    verts, faces = s.save_mesh(tmp_path / "fox.obj", resolution=r)
    assert len(verts) > 100 and faces.max() < len(verts)
    tri = load_obj(tmp_path / "fox.obj")
    np.testing.assert_allclose(tri, verts[faces], rtol=1e-6)
    text = (tmp_path / "fox.obj").read_text()
    assert text.count("\nvn ") == len(verts) and len(text.splitlines()[0].split()) == 7
    # the vertex colours against the reference's colour function
    cols = np.array([line.split()[4:7] for line in text.splitlines() if line.startswith("v ")],
                    np.float32)
    unit = jnp.clip((jnp.asarray(verts) - jeng.aabb.min) / jeng.aabb.diag, 0.0, 1.0)
    nrm = -np.array([line.split()[1:4] for line in text.splitlines() if line.startswith("vn")],
                    np.float32)
    rgb_raw, _ = nerf_apply(jeng.net, jparams, unit, (jnp.asarray(nrm) + 1.0) * 0.5)
    np.testing.assert_allclose(cols, np.asarray(apply_rgb_activation(
        rgb_raw, jeng.net.rgb_activation)), **MLP_TOL)
    v2 = s.optimise_mesh_step(n_steps=2)
    assert v2.shape == verts.shape and 0 < np.abs(v2 - verts).max() < 1e-2


def test_sdf_mesh(tmp_path):
    from sienerf_torch.common import TestbedMode
    from sienerf_torch.engines.sdf import SdfEngine
    from sienerf_torch.session import Session
    from test_torch_sdf import small_config, unit_scene

    s = Session(device="cpu")
    s.engine = SdfEngine.create(small_config(), unit_scene(), batch_size=1 << 11, device="cpu")
    s.state, s.mode = s.engine.init(0), TestbedMode.SDF
    g = torch.Generator().manual_seed(0)
    for _ in range(4):
        s.state, _ = s.engine.train_bundle(s.state, g)
    verts, faces = s.save_mesh(tmp_path / "sdf.ply", resolution=32)
    assert len(faces) > 200
    assert (tmp_path / "sdf.ply").read_bytes().startswith(b"ply\n")
    # the zero level: the field is small at the vertices
    from sienerf_torch.models.single_network import apply_single_network

    val = apply_single_network(s.engine.net, s.render_params(), torch.from_numpy(verts))[:, 0]
    assert float(val.abs().median()) < 0.02
    v2 = s.optimise_mesh_step(n_steps=2)
    assert v2.shape == verts.shape
    with pytest.raises(RuntimeError, match="NeRF and SDF"):
        Session(device="cpu").save_mesh(tmp_path / "x.obj")
