"""The slice as a whole: the port's Session renders the fox snapshot like
the reference.  Each package bakes at R=16 with its own code; 64x64 sweep
frames along all three axes (one flipped; the views of
tests/test_shade_pallas.py::test_fused_prep_frame_matches_xla), at spp 1
and 2, against the reference's XLA frame, at rtol 2e-2 / atol 5e-3."""

import numpy as np
import pytest
import torch

from test_torch_snapshot import fox_jax, fox_jax_bake, fox_port_session

H = W = 64
FOCAL = (48.0, 48.0)
EYES = {  # eye -> expected (sweep axis, flip)
    (0.5, 0.5, -1.6): (2, False),
    (2.1, 0.5, 0.6): (0, True),
    (0.4, -1.3, 0.5): (1, False),
}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cam(eye):
    from sienerf_torch.utils.camera import look_at_matrix

    return look_at_matrix(list(eye), [0.5, 0.5, 0.5])


def _jax_session():
    from sienerf_tpu.common import TestbedMode
    from sienerf_tpu.session import Session as JaxSession

    eng, params, bitfield = fox_jax()
    js = JaxSession()
    js.mode = TestbedMode.NERF
    js.engine = eng
    js.state = {"opt": {}, "params": params, "occ": {"bitfield": bitfield}}
    js._baked = fox_jax_bake(16)
    return js


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("eye", list(EYES))
def test_session_sweep_frame_matches_reference(eye, spp):
    from sienerf_torch.engines.nerf_sweep import _pick_axis

    cam = _cam(eye)
    assert _pick_axis(cam, FOCAL, W, H) == EYES[eye]
    want = _jax_session().render(W, H, cam, FOCAL, spp=spp, renderer="sweep",
                                 impl="xla", min_transmittance=1e-4)
    s = fox_port_session()
    got = s.render(W, H, cam, FOCAL, spp=spp, renderer="sweep",
                   bake_resolution=16, min_transmittance=1e-4)
    assert got.shape == (H, W, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=5e-3)
    # a real image: finite, mostly opaque (the fox capture's background is
    # in the field; from -z the camera looks through it), not constant
    assert np.isfinite(got.numpy()).all()
    assert got[..., 3].mean() > 0.5 and got[..., :3].std() > 1e-3


@pytest.mark.parametrize("eye", list(EYES))
def test_frame_on_reference_bake_matches(eye):
    """Same bake in both packages (baked_grid_from_jax): only the renderers differ."""
    from sienerf_tpu.engines.nerf_sweep import render_frame_sweep as jax_frame
    from sienerf_torch.convert import baked_grid_from_jax
    from sienerf_torch.engines.nerf_sweep import render_frame_sweep

    jeng, jparams, _ = fox_jax()
    jgrid, meta = fox_jax_bake(16)
    cam = _cam(eye)
    want_rgba, want_depth = jax_frame(jeng, jparams, jgrid, meta, cam, FOCAL, width=W,
                                      height=H, min_transmittance=1e-4, impl="xla",
                                      axis_phase=np.float32(0.25))
    s = fox_port_session()
    rgba, depth = render_frame_sweep(s.engine, s.state["params"],
                                     baked_grid_from_jax(jgrid, device="cpu"), meta, cam,
                                     FOCAL, width=W, height=H, min_transmittance=1e-4,
                                     axis_phase=np.float32(0.25))
    np.testing.assert_allclose(rgba.numpy(), np.asarray(want_rgba), rtol=2e-2, atol=5e-3)
    # depth: the best-weight slab's t; compare where the frame is opaque
    opaque = np.asarray(want_rgba)[..., 3] > 0.5
    np.testing.assert_allclose(depth.numpy()[opaque], np.asarray(want_depth)[opaque],
                               rtol=2e-2, atol=5e-3)
