"""The hybrid frame with several NeRF objects, port vs reference: the box
scene of tests/test_torch_geometry.py with the tiny seeded field of
tests/test_torch_live.py attached twice, at two centres, each object's
NeRF rendered by the baked gather renderer (render_rays_baked, P=64,
evals=16, step_scale 4, its march capped at the mesh depth) on one R=16
bake in both packages (the reference's, carried across by
convert.baked_grid_from_jax).  renderer="sweep" with two NeRF objects takes
the same path.

Tolerance: the live frame's rule (tests/test_torch_live.py: at least 99 %
of the pixels within rtol 2e-2 / atol 5e-3, PSNR above 40 dB); the z-depth
finite on the same pixels and within rtol 1e-5 / atol 1e-6 where the mesh
lies in front (the mesh pass's tolerance)."""

import functools

import jax
import numpy as np
import pytest
import torch

from test_torch_baked import hold_frame
from test_torch_geometry import FOCAL, W, _cam, _field_objects, engines

CENTERS = ([-0.55, 0.1, 0.0], [0.5, -0.15, 0.2])


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@functools.lru_cache(maxsize=1)
def two_field_engines():
    """(reference, port) geometry engines with the field at two centres,
    both objects holding the reference's R=16 bake."""
    from sienerf_torch.convert import baked_grid_from_jax

    jg, tg = engines()
    for c in CENTERS:
        jo, to = _field_objects()
        jo.center = to.center = np.asarray(c, np.float32)
        grid, meta = jo.nerf.bake_features(jo.nerf_state["params"], jo.nerf_state["occ"],
                                           resolution=16)
        jo._bake = (grid, meta)
        to._bake = (baked_grid_from_jax(jax.tree.map(np.asarray, grid), "cpu"), dict(meta))
        jg.objects.append(jo)
        tg.objects.append(to)
    return jg, tg


@pytest.mark.parametrize("renderer", ["baked", "sweep"])
def test_baked_hybrid_two_nerf_objects(renderer):
    jg, tg = two_field_engines()
    cam = _cam()
    want, wd = jg.render_frame(W, W, cam, FOCAL, tile=W * W, renderer=renderer)
    got, gd = tg.render_frame(W, W, cam, FOCAL, tile=1000, renderer=renderer)
    want, wd, got, gd = np.asarray(want), np.asarray(wd), got.numpy(), gd.numpy()
    hold_frame(got, want)
    fin = np.isfinite(wd)
    assert np.mean(np.isfinite(gd) == fin) >= 0.99
    # the fields render off the mesh (96 pixels of 2,304)
    _, md = engines()[1].render_frame(W, W, cam, FOCAL)
    nerf_region = (got[..., 3] > 0.5) & ~np.isfinite(md.numpy())
    assert nerf_region.sum() > 50
    assert 0.02 < fin.mean() < 0.98


def test_baked_hybrid_matches_per_object_rays():
    """Each object's part of the port's hybrid frame is render_rays_baked of
    that object's rays, blended over the mesh in order: the frame with the
    objects one by one."""
    _, tg = two_field_engines()
    cam = _cam()
    both, _ = tg.render_frame(W, W, cam, FOCAL, renderer="baked")
    objs = list(tg.objects)
    try:
        tg.objects = [o for o in objs if o.kind != "nerf"] + [objs[-2]]
        first, _ = tg.render_frame(W, W, cam, FOCAL, renderer="baked")
    finally:
        tg.objects = objs
    # the second object only adds where it lies in front
    assert float((both[..., 3] - first[..., 3]).min()) >= -1e-6
    assert float((both[..., 3] - first[..., 3]).max()) > 0.05
