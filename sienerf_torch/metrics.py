"""Image-quality metrics of the eval protocol (port of the JAX package's
metrics.py): MSE / PSNR, SSIM with gaussian windows, L1 and the relative
variants.  They run on the host in float64 numpy, as the JAX package's do;
a tensor argument (on any device) is copied to the host first.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def mse(a, b):
    return float(np.mean((_f64(a) - _f64(b)) ** 2))


def mse2psnr(x: float) -> float:
    return -10.0 * np.log10(max(x, 1e-12))


def psnr(a, b) -> float:
    return mse2psnr(mse(a, b))


def l1(a, b):
    return float(np.mean(np.abs(_f64(a) - _f64(b))))


def mape(a, b, eps=1e-2):
    a, b = _f64(a), _f64(b)
    return float(np.mean(np.abs(a - b) / (np.abs(b) + eps)))


def smape(a, b, eps=1e-2):
    a, b = _f64(a), _f64(b)
    return float(np.mean(2 * np.abs(a - b) / (np.abs(a) + np.abs(b) + eps)))


def mrse(a, b, eps=1e-2):
    a, b = _f64(a), _f64(b)
    return float(np.mean((a - b) ** 2 / (b * b + eps)))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d_separable(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """'valid'-mode separable gaussian filtering over (H,W[,C])."""
    from numpy.lib.stride_tricks import sliding_window_view

    def conv1(x, axis):
        win = sliding_window_view(x, len(k), axis=axis)
        return np.tensordot(win, k, axes=([-1], [0]))

    out = conv1(img, 0)
    out = conv1(out, 1)
    return out


def ssim(a, b, data_range: float = 1.0) -> float:
    """Structural similarity, gaussian-window variant."""
    a = _f64(a)
    b = _f64(b)
    if a.ndim == 3:
        return float(np.mean([ssim(a[..., c], b[..., c], data_range) for c in range(a.shape[-1])]))
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_a = _filter2d_separable(a, k)
    mu_b = _filter2d_separable(b, k)
    mu_aa = mu_a * mu_a
    mu_bb = mu_b * mu_b
    mu_ab = mu_a * mu_b
    s_aa = _filter2d_separable(a * a, k) - mu_aa
    s_bb = _filter2d_separable(b * b, k) - mu_bb
    s_ab = _filter2d_separable(a * b, k) - mu_ab
    num = (2 * mu_ab + c1) * (2 * s_ab + c2)
    den = (mu_aa + mu_bb + c1) * (s_aa + s_bb + c2)
    return float(np.mean(num / den))


def luminance(rgb):
    rgb = _f64(rgb)
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


def compute_error(metric: str, img, ref) -> float:
    """Dispatch by metric name."""
    m = metric.upper()
    if m == "MSE":
        return mse(img, ref)
    if m == "PSNR":
        return psnr(img, ref)
    if m == "SSIM":
        return ssim(img, ref)
    if m == "L1":
        return l1(img, ref)
    if m == "MAPE":
        return mape(img, ref)
    if m == "SMAPE":
        return smape(img, ref)
    if m == "MRSE":
        return mrse(img, ref)
    if m == "FLIP":
        from sienerf_torch.flip import flip_error

        return flip_error(img, ref)
    raise ValueError(f"unknown metric {metric}")
