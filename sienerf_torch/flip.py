"""LDR-FLIP perceptual difference metric (port of the JAX package's flip.py,
a compact numpy implementation of NVIDIA FLIP, Andersson et al. 2020, on
the host; a tensor argument is copied to the host first).  The LDR
pipeline: sRGB -> YCxCz, CSF-filtered color difference (HyAB in
L*a*b*), Sobel-based feature (edge/point) difference, and the final
per-pixel pooling `1 - (1-dc)^(1-df)`; returns the mean FLIP error.
"""

from __future__ import annotations

import numpy as np

from sienerf_torch.metrics import _f64

_PPD_DEFAULT = 67.0  # pixels per degree (reference default viewing setup)


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


_RGB2XYZ = np.array(
    [[0.4124, 0.3576, 0.1805], [0.2126, 0.7152, 0.0722], [0.0193, 0.1192, 0.9505]]
)
_D65 = np.array([0.9505, 1.0, 1.089])


def _linear_rgb_to_xyz(rgb):
    return rgb @ _RGB2XYZ.T


def _xyz_to_ycxcz(xyz):
    y = 116.0 * (xyz[..., 1] / _D65[1]) - 16.0
    cx = 500.0 * (xyz[..., 0] / _D65[0] - xyz[..., 1] / _D65[1])
    cz = 200.0 * (xyz[..., 1] / _D65[1] - xyz[..., 2] / _D65[2])
    return np.stack([y, cx, cz], axis=-1)


def _ycxcz_to_xyz(ycxcz):
    yy = (ycxcz[..., 0] + 16.0) / 116.0
    x = (ycxcz[..., 1] / 500.0 + yy) * _D65[0]
    z = (yy - ycxcz[..., 2] / 200.0) * _D65[2]
    return np.stack([x, yy * _D65[1], z], axis=-1)


def _xyz_to_lab(xyz):
    t = xyz / _D65

    def f(v):
        d = 6.0 / 29.0
        return np.where(v > d**3, np.cbrt(np.maximum(v, 1e-12)), v / (3 * d * d) + 4.0 / 29.0)

    ft = f(t)
    L = 116.0 * ft[..., 1] - 16.0
    a = 500.0 * (ft[..., 0] - ft[..., 1])
    b = 200.0 * (ft[..., 1] - ft[..., 2])
    return np.stack([L, a, b], axis=-1)


def _gauss2d(sigma, radius):
    x = np.arange(-radius, radius + 1)
    xx, yy = np.meshgrid(x, x)
    g = np.exp(-(xx**2 + yy**2) / (2 * sigma**2))
    return g / g.sum()


def _conv2(img, kern):
    """Same-size 2D convolution with edge clamping, per channel."""
    from numpy.lib.stride_tricks import sliding_window_view

    r = kern.shape[0] // 2
    pad = np.pad(img, ((r, r), (r, r)), mode="edge")
    win = sliding_window_view(pad, kern.shape, axis=(0, 1))
    return np.einsum("ijkl,kl->ij", win, kern)


def _csf_filter(ycxcz, ppd):
    """Per-channel gaussian approximations of the CSFs (FLIP sec. 3.1)."""
    # (a1, b1, a2, b2) parameters per channel from the FLIP paper
    params = {
        0: [(1.0, 0.0047), (0.0, 1e-5)],  # Y (achromatic)
        1: [(1.0, 0.0053), (0.0, 1e-5)],  # Cx (red-green)
        2: [(34.1, 0.04), (13.5, 0.025)],  # Cz (blue-yellow) two lobes
    }
    out = np.empty_like(ycxcz)
    for c in range(3):
        sigmas = [0.5 * np.sqrt(b) * ppd for (_a, b) in params[c]]
        sigma = max(max(sigmas), 0.35)
        radius = max(int(np.ceil(3 * sigma)), 1)
        k = _gauss2d(sigma, radius)
        out[..., c] = _conv2(ycxcz[..., c], k)
    return out


def _feature_detect(y, ppd):
    """Edge and point responses on luminance (first/second gaussian derivs)."""
    sigma = 0.5 * 0.082 * ppd
    radius = max(int(np.ceil(3 * sigma)), 1)
    x = np.arange(-radius, radius + 1)
    xx, yy = np.meshgrid(x, x)
    g = np.exp(-(xx**2 + yy**2) / (2 * sigma**2))
    gx = -xx / (sigma**2) * g
    gxx = (xx**2 / sigma**4 - 1.0 / sigma**2) * g
    # normalize as in FLIP: positive/negative parts scaled to unit sums
    def norm(k):
        pos = k.clip(0).sum()
        neg = -k.clip(max=0).sum()
        s = max(pos, neg, 1e-12)
        return k / s

    gx, gy = norm(gx), norm(gx.T)
    gxx, gyy = norm(gxx), norm(gxx.T)
    ex = _conv2(y, gx)
    ey = _conv2(y, gy)
    px = _conv2(y, gxx)
    py = _conv2(y, gyy)
    edge = np.sqrt(ex**2 + ey**2)
    point = np.sqrt(px**2 + py**2)
    return edge, point


def flip_error(test, reference, ppd: float = _PPD_DEFAULT) -> float:
    """Mean LDR-FLIP error between two sRGB images in [0,1] (H,W,3)."""
    t = np.clip(_f64(test)[..., :3], 0, 1)
    r = np.clip(_f64(reference)[..., :3], 0, 1)

    t_ycc = _xyz_to_ycxcz(_linear_rgb_to_xyz(_srgb_to_linear(t)))
    r_ycc = _xyz_to_ycxcz(_linear_rgb_to_xyz(_srgb_to_linear(r)))
    t_f = _csf_filter(t_ycc, ppd)
    r_f = _csf_filter(r_ycc, ppd)

    # color difference: HyAB in L*a*b* after clamping back through linear RGB
    def to_lab(ycc):
        xyz = _ycxcz_to_xyz(ycc)
        return _xyz_to_lab(np.clip(xyz, 0.0, None))

    t_lab = to_lab(t_f)
    r_lab = to_lab(r_f)
    hyab = np.abs(t_lab[..., 0] - r_lab[..., 0]) + np.linalg.norm(
        t_lab[..., 1:] - r_lab[..., 1:], axis=-1
    )
    # normalize by the max HyAB between green and blue (paper's cmax), with
    # the perceptual exponent qc = 0.7
    green = _xyz_to_lab(_linear_rgb_to_xyz(np.array([[[0.0, 1.0, 0.0]]])))
    blue = _xyz_to_lab(_linear_rgb_to_xyz(np.array([[[0.0, 0.0, 1.0]]])))
    cmax = (
        np.abs(green[..., 0] - blue[..., 0])
        + np.linalg.norm(green[..., 1:] - blue[..., 1:], axis=-1)
    ).item()
    pccmax = 0.4 * cmax
    dc = hyab ** 0.7
    dc = np.where(dc < pccmax, 0.5 * dc / pccmax, 1.0 - (0.5 * pccmax) / np.maximum(dc, 1e-12))
    dc = np.clip(dc, 0.0, 1.0)

    # feature difference on normalized achromatic channel, qf = 0.5
    ty = (t_ycc[..., 0] + 16.0) / 116.0
    ry = (r_ycc[..., 0] + 16.0) / 116.0
    te, tp = _feature_detect(ty, ppd)
    re, rp = _feature_detect(ry, ppd)
    df = np.maximum(np.abs(te - re), np.abs(tp - rp))
    df = np.clip((1.0 / np.sqrt(2.0)) * df, 0.0, 1.0) ** 0.5

    flip = 1.0 - (1.0 - dc) ** (1.0 - df)
    return float(np.mean(flip))
