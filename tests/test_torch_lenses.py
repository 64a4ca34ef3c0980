"""Lenses, camera slerp and the distortion map, port vs reference:
uv_to_ray for every LensMode (and with a distortion map), the trainer's
per-ray _batched_uv_to_ray, rotation <-> quaternion and camera_slerp,
_apply_se3_delta, render mode "distortion", and Session.render with
`camera_matrix_end` (motion blur over spp passes, each at the reference's
slerped camera) through an OpenCV lens, on the seeded ball field of
tests/test_torch_live.py.

Tolerances:
- rays: rtol 1e-5 / atol 2e-6 (f32 ulps of sin, cos, atan and sqrt, and
  eight fixed-point undistortion iterations);
- quaternions, slerped cameras and se(3) deltas: atol 1e-6 (the slerp's
  ends meet the given cameras within 2e-5, the f32 quaternion round trip);
- the distortion frame: rtol 1e-4 / atol 1e-4 (a colour wheel of 64x the
  uv shift, so an ulp of the ray moves it by ~64 ulps);
- the motion-blurred frame against its passes at the reference's slerped
  cameras: the live frame's rule (at least 99 % of pixels within rtol 2e-2
  / atol 5e-3, tests/test_torch_live.py): the session slerps in f32 on the
  port's side."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_live import FOCAL, H, W, _cam, tiny

RAY_TOL = dict(rtol=1e-5, atol=2e-6)
FRAME_TOL = dict(rtol=2e-2, atol=5e-3)
# lens params: OpenCV k1 k2 p1 p2; fisheye k1..k4; F-theta r0..r4, resx, resy
LENSES = {"perspective": (), "opencv": (-0.12, 0.03, 1e-3, -2e-3),
          "opencv_fisheye": (0.05, -0.01, 2e-3, -1e-3),
          "ftheta": (0.0, 0.02, 1e-5, 0.0, 0.0, 64.0, 48.0), "latlong": (),
          "equirectangular": ()}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _look(eye):
    from sienerf_torch.utils.camera import look_at_matrix

    return look_at_matrix(list(eye), [0.5, 0.5, 0.5])


def _lenses(mode):
    from sienerf_tpu.common import LensMode as JMode
    from sienerf_tpu.utils.camera import Lens as JLens
    from sienerf_torch.common import LensMode
    from sienerf_torch.utils.camera import Lens

    return (JLens(JMode(mode), LENSES[mode]), Lens(LensMode(mode), LENSES[mode]))


def _pixels(w=64, h=48):
    from sienerf_torch.utils.camera import pixel_grid_uv

    return pixel_grid_uv(w, h).reshape(-1, 2)


@pytest.mark.parametrize("mode", [*LENSES, "distortion_map"])
def test_uv_to_ray_matches(mode):
    from sienerf_tpu.utils.camera import uv_to_ray as jray
    from sienerf_torch.utils.camera import uv_to_ray

    dist = None
    if mode == "distortion_map":
        mode = "opencv"
        dist = np.random.default_rng(1).normal(0, 0.02, (8, 8, 2)).astype(np.float32)
    jl, tl = _lenses(mode)
    uv = _pixels()
    cam = _cam()
    args = ((64, 48), (52.0, 55.0), cam, (0.47, 0.53))
    want = jray(jnp.asarray(uv.numpy()), *args, jl,
                distortion_grid=None if dist is None else jnp.asarray(dist))
    got = uv_to_ray(uv, *args, tl, distortion_grid=None if dist is None
                    else torch.from_numpy(dist))
    for name, a, b in zip(("origin", "direction"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **RAY_TOL, err_msg=name)
    if mode != "perspective":  # the lens changes the rays
        plain = uv_to_ray(uv, *args)[1]
        assert float((plain - got[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("mode", ["opencv", "opencv_fisheye", "distortion_map"])
def test_batched_uv_to_ray_matches(mode):
    from sienerf_tpu.engines.nerf import _batched_uv_to_ray as jbatched
    from sienerf_torch.engines.nerf import _batched_uv_to_ray

    rng = np.random.default_rng(2)
    n = 512
    dist = None
    if mode == "distortion_map":
        mode = "opencv"
        dist = rng.normal(0, 0.02, (32, 32, 2)).astype(np.float32)
    jl, tl = _lenses(mode)
    uv = rng.random((n, 2)).astype(np.float32)
    focal = rng.uniform(40, 60, (n, 2)).astype(np.float32)
    pp = rng.uniform(0.45, 0.55, (n, 2)).astype(np.float32)
    xf = np.stack([_look((1.4 + 0.1 * i, 0.8, -0.5)) for i in range(4)])[rng.integers(0, 4, n)]
    want = jbatched(jnp.asarray(uv), (64, 48), jnp.asarray(focal), jnp.asarray(pp),
                    jnp.asarray(xf), jl, None if dist is None else jnp.asarray(dist))
    got = _batched_uv_to_ray(torch.from_numpy(uv), (64, 48), torch.from_numpy(focal),
                             torch.from_numpy(pp), torch.from_numpy(xf), tl,
                             None if dist is None else torch.from_numpy(dist))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **RAY_TOL)


def _rotations(n, rng):
    from scipy.spatial.transform import Rotation

    return Rotation.random(n, random_state=int(rng.integers(1 << 30))).as_matrix().astype(
        np.float32)


def test_quaternions_and_camera_slerp_match():
    from sienerf_tpu.utils import camera as jcam
    from sienerf_torch.utils import camera as tcam

    rng = np.random.default_rng(3)
    n = 256
    a = np.concatenate([_rotations(n, rng), rng.normal(size=(n, 3, 1))], -1).astype(np.float32)
    b = np.concatenate([_rotations(n, rng), rng.normal(size=(n, 3, 1))], -1).astype(np.float32)
    b[:8] = a[:8]  # equal ends: the small-angle branch
    t = rng.random(n).astype(np.float32)
    t[8:12] = (0.0, 1.0, 0.0, 1.0)
    q = tcam.rotation_to_quat(torch.from_numpy(a[..., :3]))
    np.testing.assert_allclose(q.numpy(), np.asarray(jcam.rotation_to_quat(jnp.asarray(
        a[..., :3]))), atol=1e-6)
    np.testing.assert_allclose(tcam.quat_to_rotation(q).numpy(), a[..., :3], atol=2e-6)
    want = np.asarray(jcam.camera_slerp(jnp.asarray(a), jnp.asarray(b), jnp.asarray(t)))
    got = tcam.camera_slerp(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # the ends, through the f32 quaternion round trip of both packages
    np.testing.assert_allclose(got.numpy()[8:12:2], a[8:12:2], atol=2e-5)  # t = 0: start
    np.testing.assert_allclose(got.numpy()[9:12:2], b[9:12:2], atol=2e-5)  # t = 1: end


def test_apply_se3_delta_matches():
    from sienerf_tpu.engines.nerf import _apply_se3_delta as jdelta
    from sienerf_torch.engines.nerf import _apply_se3_delta

    rng = np.random.default_rng(4)
    xf = np.concatenate([_rotations(64, rng), rng.normal(size=(64, 3, 1))], -1).astype(
        np.float32)
    delta = rng.normal(0, 0.01, (64, 6)).astype(np.float32)
    want = np.asarray(jdelta(jnp.asarray(xf), jnp.asarray(delta)))
    np.testing.assert_allclose(_apply_se3_delta(torch.from_numpy(xf),
                                                torch.from_numpy(delta)).numpy(), want,
                               atol=1e-6)


def _lens_engines(mode="opencv"):
    jeng, jp, teng, tp, bf = tiny()
    jl, tl = _lenses(mode)
    return dataclasses.replace(jeng, lens=jl), jp, dataclasses.replace(teng, lens=tl), tp, bf


def test_distortion_frame_matches():
    jeng, jp, teng, tp, bf = _lens_engines()
    dist = np.random.default_rng(5).normal(0, 0.02, (8, 8, 2)).astype(np.float32)
    want, _ = jeng.render_frame(dict(jp, distortion=jnp.asarray(dist)), jnp.asarray(bf), W, H,
                                _cam(), FOCAL, render_mode="distortion")
    got, depth = teng.render_frame(dict(tp, distortion=torch.from_numpy(dist)),
                                   torch.from_numpy(bf), W, H, _cam(), FOCAL,
                                   render_mode="distortion")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    assert float(got[..., :3].max()) > 0.1 and bool((depth == 1.0).all())
    # a pinhole without a map shifts nothing: black
    plain, _ = tiny()[2].render_frame(tp, torch.from_numpy(bf), W, H, _cam(), FOCAL,
                                      render_mode="distortion")
    assert float(plain[..., :3].abs().max()) < 1e-4


def test_motion_blur_render_through_a_lens_matches():
    """Session.render(camera_matrix_end=..., spp=4) through an OpenCV lens:
    pass i renders at the reference's camera_slerp (i + 0.5) / 4 of the
    way, with its low-discrepancy subpixel offset, and the passes average
    in float64, as the reference's Session.render composes them."""
    from sienerf_tpu.utils.camera import camera_slerp as jslerp
    from sienerf_torch.common import TestbedMode
    from sienerf_torch.ops.samplers import ld_pixel_offset
    from sienerf_torch.session import Session

    _, _, teng, tp, bf = _lens_engines()
    start, end = _cam(), _look((1.2, 0.6, -0.8))
    s = Session(device="cpu")
    s.mode, s.engine = TestbedMode.NERF, teng
    s.state = {"params": tp, "occ": {"bitfield": torch.from_numpy(bf)}}
    got = s.render(W, H, start, FOCAL, spp=4, camera_matrix_end=end)
    want = 0.0
    for i in range(4):
        cam = np.asarray(jslerp(start[None], end[None], np.asarray([(i + 0.5) / 4]))[0])
        rgba, _ = teng.render_frame(tp, torch.from_numpy(bf), W, H, cam, FOCAL,
                                    pixel_offset=ld_pixel_offset(i))
        want = want + rgba.double()
    want = (want / 4).float().numpy()
    err = np.abs(got.numpy() - want)
    ok = (err <= FRAME_TOL["atol"] + FRAME_TOL["rtol"] * np.abs(want)).all(axis=-1)
    assert ok.mean() >= 0.99 and float(got[..., 3].mean()) > 0.05
    still = s.render(W, H, start, FOCAL, spp=4).numpy()
    assert np.abs(still - got.numpy()).max() > 0.05  # the blur moved the frame
