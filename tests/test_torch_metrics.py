"""Port vs reference: the quality measures (psnr, ssim and the other error
metrics, LDR-FLIP) and the tonemap epilogue, on seeded images.

Tolerance rtol 1e-5: the metrics are the same float64 numpy code in both
packages, the tonemap curves the same f32 operations (pow and log may
differ in the last bit between XLA and PyTorch)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_tpu import flip as jflip
from sienerf_tpu import metrics as jmetrics
from sienerf_tpu.common import ColorSpace as JColorSpace
from sienerf_tpu.common import TonemapCurve as JTonemapCurve
from sienerf_tpu.ops import tonemap as jtm
from sienerf_torch import flip as tflip
from sienerf_torch import metrics as tmetrics
from sienerf_torch.common import ColorSpace, TonemapCurve
from sienerf_torch.ops import tonemap as ttm

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _images(seed=0, h=40, w=56):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(xx / 7.0), np.cos(yy / 5.0), np.sin((xx + yy) / 9.0)], -1)
    a = np.clip(0.5 + 0.4 * base + rng.normal(0, 0.02, (h, w, 3)), 0, 1).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, (h, w, 3)), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("metric", ["MSE", "PSNR", "SSIM", "L1", "MAPE", "SMAPE", "MRSE",
                                    "FLIP"])
def test_compute_error_matches(metric):
    a, b = _images()
    want = jmetrics.compute_error(metric, a, b)
    got = tmetrics.compute_error(metric, torch.from_numpy(a), torch.from_numpy(b))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_psnr_ssim_properties():
    a, b = _images(1)
    assert tmetrics.ssim(a, a) == pytest.approx(1.0)
    assert tmetrics.psnr(a, a) == pytest.approx(120.0)  # the 1e-12 floor
    np.testing.assert_allclose(tmetrics.psnr(a, b), jmetrics.psnr(a, b), rtol=RTOL)
    np.testing.assert_allclose(tmetrics.ssim(a[..., 0], b[..., 0]),
                               jmetrics.ssim(a[..., 0], b[..., 0]), rtol=RTOL)
    np.testing.assert_allclose(tmetrics.luminance(a), jmetrics.luminance(a), rtol=RTOL)
    with pytest.raises(ValueError):
        tmetrics.compute_error("nope", a, b)


def test_flip_error_matches_and_orders():
    a, b = _images(2)
    np.testing.assert_allclose(tflip.flip_error(a, b), jflip.flip_error(a, b), rtol=RTOL)
    assert tflip.flip_error(a, a) == 0.0
    c = np.clip(a + 0.3, 0, 1)
    assert tflip.flip_error(a, c) > tflip.flip_error(a, b) > 0.0


@pytest.mark.parametrize("curve", ["IDENTITY", "ACES", "HABLE", "REINHARD"])
@pytest.mark.parametrize("space", ["SRGB", "LINEAR"])
def test_tonemap_frame_matches(curve, space):
    rng = np.random.default_rng(3)
    rgba = rng.uniform(-0.1, 4.0, (24, 32, 4)).astype(np.float32)
    want = jtm.tonemap_frame(jnp.asarray(rgba), exposure=0.7,
                             tonemap_curve=JTonemapCurve[curve],
                             color_space=JColorSpace[space])
    got = ttm.tonemap_frame(torch.from_numpy(rgba), exposure=0.7,
                            tonemap_curve=TonemapCurve[curve],
                            color_space=ColorSpace[space])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-6)
    raw = ttm.tonemap_frame(torch.from_numpy(rgba), tonemap_curve=TonemapCurve[curve],
                            color_space=ColorSpace[space], clamp_output=False)
    want_raw = jtm.tonemap_frame(jnp.asarray(rgba), tonemap_curve=JTonemapCurve[curve],
                                 color_space=JColorSpace[space], clamp_output=False)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_raw), rtol=RTOL, atol=1e-6)


def test_colour_space_round_trip_and_helpers():
    rng = np.random.default_rng(4)
    c = rng.uniform(0.0, 1.0, (512,)).astype(np.float32)
    np.testing.assert_allclose(ttm.srgb_to_linear(torch.from_numpy(c)).numpy(),
                               np.asarray(jtm.srgb_to_linear(jnp.asarray(c))), rtol=RTOL)
    np.testing.assert_allclose(ttm.linear_to_srgb(torch.from_numpy(c)).numpy(),
                               np.asarray(jtm.linear_to_srgb(jnp.asarray(c))), rtol=RTOL)
    back = ttm.linear_to_srgb(ttm.srgb_to_linear(torch.from_numpy(c)))
    np.testing.assert_allclose(back.numpy(), c, atol=1e-5)
    acc, frame = rng.uniform(0, 1, (2, 8, 8, 4)).astype(np.float32)
    np.testing.assert_allclose(
        ttm.accumulate(torch.from_numpy(acc), torch.from_numpy(frame), 3).numpy(),
        np.asarray(jtm.accumulate(jnp.asarray(acc), jnp.asarray(frame), 3)), rtol=RTOL)
    np.testing.assert_allclose(
        ttm.error_overlay(torch.from_numpy(acc[..., :3]), torch.from_numpy(frame[..., :3])).numpy(),
        np.asarray(jtm.error_overlay(jnp.asarray(acc[..., :3]), jnp.asarray(frame[..., :3]))),
        rtol=1e-4, atol=1e-6)


def test_flow_wheel_matches():
    rng = np.random.default_rng(5)
    flow = rng.normal(0, 0.5, (33, 17, 2)).astype(np.float32)
    flow[0, 0] = 0.0
    np.testing.assert_allclose(ttm.flow_to_rgb(torch.from_numpy(flow)).numpy(),
                               np.asarray(jtm.flow_to_rgb(jnp.asarray(flow))),
                               rtol=1e-4, atol=1e-5)
    h, s, v = rng.uniform(0, 1, (3, 256)).astype(np.float32)
    s[:8] = 0.0
    np.testing.assert_allclose(
        ttm.hsv_to_rgb(torch.from_numpy(h), torch.from_numpy(s), torch.from_numpy(v)).numpy(),
        np.asarray(jtm.hsv_to_rgb(jnp.asarray(h), jnp.asarray(s), jnp.asarray(v))),
        rtol=RTOL, atol=1e-6)
