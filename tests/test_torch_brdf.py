"""Shading helpers, port vs reference on seeded inputs: the Disney BRDF
with the fork's ambient term, sky ambient, the checkerboard floor, the
soft-shadow accumulator, the lat-long envmap read and the background behind
it, the bilinear 2-D fetch, the lat-long direction maps and the 2-D Halton
set.

Tolerances: rtol 1e-5 / atol 1e-6 (the same f32 formulas; XLA may fuse a
multiply-add the port rounds twice)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

TOL = dict(rtol=1e-5, atol=1e-6)
N = 4096


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _unit(rng, n=N):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _both(fn_j, fn_t, *arrays, **kw):
    a = np.asarray(fn_j(*[jnp.asarray(x) for x in arrays], **kw))
    b = fn_t(*[torch.from_numpy(x) for x in arrays], **kw).numpy()
    return a, b


PARAMS = [dict(), dict(metallic=0.3, subsurface=0.5, specular=0.7, roughness=0.8, sheen=0.4,
                       clearcoat=0.6, clearcoat_gloss=0.2, specular_tint=0.3, sheen_tint=0.5),
          dict(roughness=1.0, clearcoat=1.0, clearcoat_gloss=0.0), dict(metallic=1.0)]


@pytest.mark.parametrize("kw", PARAMS)
def test_evaluate_shading(kw):
    from sienerf_tpu.ops import brdf as jb
    from sienerf_torch.ops import brdf as tb

    rng = np.random.default_rng(len(kw))
    args = [rng.random((N, 3)).astype(np.float32), rng.random((N, 3)).astype(np.float32),
            (rng.random((N, 3)) * 4).astype(np.float32), _unit(rng), _unit(rng), _unit(rng)]
    a, b = _both(jb.evaluate_shading, tb.evaluate_shading, *args, **kw)
    np.testing.assert_allclose(b, a, **TOL)
    assert tb.BRDFParams() == tb.BRDFParams(**jb.BRDFParams().__dict__)


def test_sky_floor_and_soft_shadow():
    from sienerf_tpu.ops import brdf as jb
    from sienerf_torch.ops import brdf as tb

    rng = np.random.default_rng(0)
    n = _unit(rng)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    a, b = _both(jb.sky_ambient, tb.sky_ambient, n, up)
    np.testing.assert_allclose(b, a, **TOL)
    np.testing.assert_allclose(np.asarray(tb.SUN_COLOR), np.asarray(jb.SUN_COLOR), **TOL)
    pos = (rng.random((N, 3)) * 3 - 1).astype(np.float32)
    lo = np.asarray([-1.0, -1.0, -1.0])
    a = np.asarray(jb.checkerboard_floor_color(jnp.asarray(pos), lo, 3.0))
    np.testing.assert_array_equal(tb.checkerboard_floor_color(torch.from_numpy(pos), lo, 3.0)
                                  .numpy(), a)
    vals = [rng.random(N).astype(np.float32) + 0.01 for _ in range(4)]
    ja = jb.soft_shadow_update(*[jnp.asarray(v) for v in vals])
    ta = tb.soft_shadow_update(*[torch.from_numpy(v) for v in vals])
    for x, y in zip(ja, ta):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), **TOL)


def test_envmap_read_and_background():
    from sienerf_tpu.ops import envmap as je
    from sienerf_torch.ops import envmap as te

    rng = np.random.default_rng(1)
    env = rng.random((16, 32, 4)).astype(np.float32)
    d = _unit(rng)
    d[:4] = [[0, 1, 0], [0, -1, 0], [0, 0, -1], [-1e-8, 0, -1]]  # poles and the seam
    a, b = _both(je.dir_to_latlong_uv, te.dir_to_latlong_uv, d)
    np.testing.assert_allclose(b, a, **TOL)
    a, b = _both(je.read_envmap, te.read_envmap, env, d)
    np.testing.assert_allclose(b, a, **TOL)
    for bg in (np.asarray([0.2, 0.3, 0.4], np.float32), rng.random((N, 3)).astype(np.float32)):
        a, b = _both(je.background_behind_envmap, te.background_behind_envmap, env, d, bg)
        np.testing.assert_allclose(b, a, **TOL)


@pytest.mark.parametrize("align", [False, True])
def test_bilinear_sample_2d(align):
    from sienerf_tpu.ops.grids import bilinear_sample_2d as jf
    from sienerf_torch.ops.grids import bilinear_sample_2d as tf

    rng = np.random.default_rng(2)
    grid = rng.random((9, 13, 3)).astype(np.float32)
    uv = (rng.random((64, 7, 2)) * 1.4 - 0.2).astype(np.float32)
    a, b = _both(lambda g, u: jf(g, u, align), lambda g, u: tf(g, u, align), grid, uv)
    np.testing.assert_allclose(b, a, **TOL)


def test_latlong_maps_and_halton():
    from sienerf_tpu.ops.samplers import halton_2d as jh
    from sienerf_tpu.utils import camera as jc
    from sienerf_torch.ops.samplers import halton_2d as th
    from sienerf_torch.utils import camera as tc

    rng = np.random.default_rng(3)
    u, v = rng.random(N).astype(np.float32), rng.random(N).astype(np.float32)
    a, b = _both(jc.latlong_to_dir, tc.latlong_to_dir, u, v)
    np.testing.assert_allclose(b, a, **TOL)
    d = rng.standard_normal((N, 3)).astype(np.float32) * 3
    a, b = _both(jc.dir_to_latlong_uv, tc.dir_to_latlong_uv, d)
    np.testing.assert_allclose(b, a, **TOL)
    idx = np.arange(1, 40)
    np.testing.assert_array_equal(th(idx), np.asarray(jh(jnp.asarray(idx))))
