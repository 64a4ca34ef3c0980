"""The triangle BVH, port vs reference, on meshes built in code (an
icosphere of 1,280 triangles and a box): both builders, the stackless
traversal and the dense brute-force tier.

Tolerances: the builds are exact (the native build runs the repo's C++
builder in both packages; the numpy build is the same numpy code).  The
two builders split at different centroids, so their trees differ; each
traces the same hits.  Traces: hit masks agree on at least 99.9 % of the
rays (a ray through a triangle's edge may hit either neighbour when two
packages round the barycentrics apart), and where both hit the same
triangle, t within rtol 1e-5.  With these meshes and rays every ray
agrees."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu.geom import bvh as jb
from sienerf_torch.geom import bvh as tb
from sienerf_torch.geom.mesh_io import box_mesh, icosphere

FIELDS = ("bbox_min", "bbox_max", "first_tri", "tri_count", "skip", "triangles", "tri_index")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def mesh(kind):
    if kind == "sphere":
        return icosphere(3) * 0.3 + 0.5
    return np.concatenate([box_mesh((0.2, 0.3, 0.25), (0.7, 0.6, 0.5)),
                           box_mesh((0.55, 0.1, 0.6), (0.8, 0.9, 0.9))])


def rays(n=3000, seed=0, origin=(0.5, 0.5, -1.0)):
    rng = np.random.default_rng(seed)
    o = np.tile(np.asarray([origin], np.float32), (n, 1))
    o[n // 2:] = rng.uniform(-1.0, 2.0, (n - n // 2, 3))  # rays from anywhere
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[: n // 2] = 0.35 * d[: n // 2] + np.asarray([0, 0, 1], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("kind", ["sphere", "boxes"])
@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_build_is_exact(kind, builder):
    tri = mesh(kind)
    want = jb._build_bvh_numpy(tri, 4) if builder == "numpy" else jb.build_bvh(tri)
    got = tb.build_bvh(tri, builder=builder)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.n_nodes == want.n_nodes
    dev = got.as_device_arrays("cpu")
    ref = want.as_device_arrays()
    for k in ref:
        np.testing.assert_array_equal(dev[k].numpy(), np.asarray(ref[k]), err_msg=k)


def _agree(jt, jid, tt, tid):
    jid, tid = np.asarray(jid), tid.numpy()
    assert np.mean((jid >= 0) == (tid >= 0)) >= 0.999
    same = (jid == tid) & (jid >= 0)
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(jt)[same], rtol=1e-5)
    return (jid >= 0).mean()


@pytest.mark.parametrize("kind", ["sphere", "boxes"])
@pytest.mark.parametrize("t_max", [1e10, 1.2])
def test_bvh_raytrace_matches(kind, t_max):
    bvh = tb.build_bvh(mesh(kind))
    o, d = rays()
    jt, jid, ju, jv = jb.bvh_raytrace(jb.build_bvh(mesh(kind)).as_device_arrays(),
                                      jnp.asarray(o), jnp.asarray(d), t_max)
    tt, tid, tu, tv = tb.bvh_raytrace(bvh.as_device_arrays("cpu"), torch.from_numpy(o),
                                      torch.from_numpy(d), t_max)
    hit = _agree(jt, jid, tt, tid)
    assert 0.0 < hit < 0.95
    same = (np.asarray(jid) == tid.numpy()) & (tid.numpy() >= 0)
    np.testing.assert_allclose(tu.numpy()[same], np.asarray(ju)[same], rtol=1e-4, atol=1e-6)
    assert np.all(np.isinf(tt.numpy()[tid.numpy() < 0]))


@pytest.mark.parametrize("kind", ["sphere", "boxes"])
def test_brute_raytrace_matches(kind):
    bvh = tb.build_bvh(mesh(kind))
    o, d = rays(seed=1)
    tm = np.where(np.arange(len(o)) % 3 == 0, 0.8, 1e10).astype(np.float32)
    jt, jid, _, _ = jb.brute_raytrace(jb.build_brute(bvh.triangles), jnp.asarray(o),
                                      jnp.asarray(d), jnp.asarray(tm), ray_tile=1024)
    bt = tb.build_brute(bvh.triangles)
    tt, tid, _, _ = tb.brute_raytrace(bt, torch.from_numpy(o), torch.from_numpy(d),
                                      torch.from_numpy(tm), ray_tile=1024)
    _agree(jt, jid, tt, tid)
    ref = jb.build_brute(bvh.triangles)
    for k in ("G", "k", "uw", "vw"):
        np.testing.assert_array_equal(bt[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # the two tiers of the port agree, and the numpy-built tree traces alike
    bt_t, bt_id, _, _ = tb.bvh_raytrace(bvh.as_device_arrays("cpu"), torch.from_numpy(o),
                                        torch.from_numpy(d), torch.from_numpy(tm))
    _agree(bt_t.numpy(), bt_id.numpy(), tt, tid)
    nb = tb.build_bvh(mesh(kind), builder="numpy")
    n_t, n_id, _, _ = tb.bvh_raytrace(nb.as_device_arrays("cpu"), torch.from_numpy(o),
                                      torch.from_numpy(d), torch.from_numpy(tm))
    hit_n = n_id >= 0
    assert torch.equal(hit_n, bt_id >= 0)
    np.testing.assert_allclose(n_t[hit_n].numpy(), bt_t[hit_n].numpy(), rtol=1e-5)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    from sienerf_torch.geom import bvh_native

    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(bvh_native, "_SRC", bad)
    monkeypatch.setattr(bvh_native, "_SO", tmp_path / "build" / "bvh_builder.so")
    monkeypatch.setattr(bvh_native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tb.build_bvh(mesh("boxes"))
    monkeypatch.setattr(bvh_native, "_SRC", tmp_path / "missing.cpp")
    with pytest.raises(FileNotFoundError):
        tb.build_bvh(mesh("boxes"))
    with pytest.raises(ValueError):
        tb.build_bvh(mesh("boxes"), builder="embree")
