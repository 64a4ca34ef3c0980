"""Irradiance gathered from a NeRF, port vs reference: the lat-long
directions and solid angles, the SH basis, projection and irradiance, the
envmap's diffuse convolution, the envmap and probe-grid lookups on seeded
inputs; and on the tiny seeded field of tests/test_torch_live.py the
envmap marches (single origin and Halton-jittered origins) and the probe
grid's bake.

Tolerances: the closed-form functions rtol 1e-5 / atol 1e-6 (f32 products
in full f32 on both sides).  The marched envmaps and the probe bake run
the live renderer, so they take the live frame's tolerance, rtol 2e-2 /
atol 5e-3 (tests/test_torch_live.py explains the rare sample that XLA's
fused multiply-add moves across a voxel boundary)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_live import tiny

TOL = dict(rtol=1e-5, atol=1e-6)
LIVE_TOL = dict(rtol=2e-2, atol=5e-3)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_latlong_grid_and_sh_functions():
    from sienerf_tpu.engines import irradiance as ji
    from sienerf_torch.engines import irradiance as ti

    np.testing.assert_allclose(ti._latlong_dirs(24, 12).numpy(),
                               np.asarray(ji._latlong_dirs(24, 12)), **TOL)
    np.testing.assert_allclose(ti._latlong_solid_angles(24, 12).numpy(),
                               np.asarray(ji._latlong_solid_angles(24, 12)), **TOL)
    rng = np.random.default_rng(0)
    env = rng.random((12, 24, 4)).astype(np.float32) * 3
    n = rng.standard_normal((500, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    np.testing.assert_allclose(ti.sh9_basis(_t(n)).numpy(), np.asarray(ji.sh9_basis(n)), **TOL)
    c = ti.sh_project_envmap(_t(env))
    np.testing.assert_allclose(c.numpy(), np.asarray(ji.sh_project_envmap(env)), **TOL)
    np.testing.assert_allclose(ti.sh_irradiance(c, _t(n)).numpy(),
                               np.asarray(ji.sh_irradiance(jnp.asarray(c.numpy()), n)), **TOL)
    E = ti.irradiance_from_envmap(_t(env))
    np.testing.assert_allclose(E.numpy(), np.asarray(ji.irradiance_from_envmap(env)), **TOL)
    np.testing.assert_allclose(ti.sample_envmap_irradiance(E, _t(n)).numpy(),
                               np.asarray(ji.sample_envmap_irradiance(E.numpy(), n)), **TOL)


def test_sample_probe_grid():
    from sienerf_tpu.engines import irradiance as ji
    from sienerf_torch.engines import irradiance as ti

    rng = np.random.default_rng(1)
    grid = {"coeffs": rng.standard_normal((3, 3, 3, 9, 3)).astype(np.float32),
            "min": np.asarray([0.1, 0.2, 0.0], np.float32),
            "max": np.asarray([0.9, 0.7, 1.0], np.float32)}
    pos = (rng.random((700, 3)) * 1.4 - 0.2).astype(np.float32)  # inside and out
    n = rng.standard_normal((700, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    want = ji.sample_probe_grid({k: jnp.asarray(v) for k, v in grid.items()}, pos, n)
    got = ti.sample_probe_grid({k: _t(v) for k, v in grid.items()}, _t(pos), _t(n))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@functools.lru_cache(maxsize=1)
def states():
    jeng, jp, teng, tp, bf = tiny()
    return (jeng, {"params": jp, "opt": {}, "occ": {"bitfield": jnp.asarray(bf)}},
            teng, {"params": tp, "opt": {}, "occ": {"bitfield": _t(bf)}})


def test_envmaps_marched_from_the_field():
    from sienerf_tpu.engines import irradiance as ji
    from sienerf_torch.engines import irradiance as ti

    jeng, js, teng, ts = states()
    a = ji.render_envmap(jeng, js, [0.5, 0.45, 0.5], 16, 8)
    b = ti.render_envmap(teng, ts, [0.5, 0.45, 0.5], 16, 8)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **LIVE_TOL)
    assert 0.05 < float(b[..., 3].mean()) < 0.999
    a = ji.render_envmap_multi(jeng, js, [0.5, 0.5, 0.5], 3, 0.05, 16, 8)
    b = ti.render_envmap_multi(teng, ts, [0.5, 0.5, 0.5], 3, 0.05, 16, 8)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **LIVE_TOL)


def test_probe_grid_bake():
    from sienerf_tpu.engines import irradiance as ji
    from sienerf_torch.engines import irradiance as ti

    jeng, js, teng, ts = states()
    kw = dict(grid_size=2, env_width=16, env_height=8, center_offset=(0.05, 0.0, -0.05))
    a = ji.bake_probe_grid(jeng, js, [0.2, 0.2, 0.2], [0.8, 0.8, 0.8], **kw)
    b = ti.bake_probe_grid(teng, ts, [0.2, 0.2, 0.2], [0.8, 0.8, 0.8], **kw)
    assert b["coeffs"].shape == (2, 2, 2, 9, 3)
    np.testing.assert_allclose(b["coeffs"].numpy(), np.asarray(a["coeffs"]), **LIVE_TOL)
    for k in ("min", "max"):
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(a[k]))
    assert float(b["coeffs"].abs().max()) > 0.1
