"""Render-buffer epilogue ops (port of the JAX package's ops/tonemap.py):
spp accumulation, tonemap curves (ACES, Hable, Reinhard), sRGB conversion,
the squared-error overlay and the HSV flow wheel.  Plain functions on
tensors; each keeps the JAX package's operation order.
"""

from __future__ import annotations

import math

import torch

from sienerf_torch.common import ColorSpace, TonemapCurve


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow(torch.clamp((c + 0.055) / 1.055, min=1e-8), 2.4))


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    c = torch.clamp(c, min=0.0)
    return torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(torch.clamp(c, min=1e-8), 1.0 / 2.4) - 0.055)


def tonemap_aces(x: torch.Tensor) -> torch.Tensor:
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def _hable_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def tonemap_hable(x: torch.Tensor) -> torch.Tensor:
    white = _hable_partial(torch.tensor(11.2, dtype=torch.float32, device=x.device))
    return torch.clamp(_hable_partial(x) / white, 0.0, 1.0)


def tonemap_reinhard(x: torch.Tensor) -> torch.Tensor:
    return x / (1.0 + x)


def apply_tonemap(rgb: torch.Tensor, curve: TonemapCurve) -> torch.Tensor:
    if curve == TonemapCurve.ACES:
        return tonemap_aces(rgb)
    if curve == TonemapCurve.HABLE:
        return tonemap_hable(rgb)
    if curve == TonemapCurve.REINHARD:
        return tonemap_reinhard(rgb)
    return rgb


def accumulate(accum_rgba: torch.Tensor, frame_rgba: torch.Tensor, spp: int) -> torch.Tensor:
    """Running mean over samples per pixel."""
    return accum_rgba + (frame_rgba - accum_rgba) * (1.0 / (spp + 1))


def tonemap_frame(rgba: torch.Tensor, exposure: float = 0.0,
                  tonemap_curve: TonemapCurve = TonemapCurve.IDENTITY,
                  color_space: ColorSpace = ColorSpace.SRGB,
                  clamp_output: bool = True) -> torch.Tensor:
    """Linear HDR rgba -> display rgba (premultiplied alpha kept)."""
    rgb = rgba[..., :3] * (2.0 ** exposure)
    rgb = apply_tonemap(rgb, tonemap_curve)
    if color_space == ColorSpace.SRGB:
        rgb = linear_to_srgb(rgb)
    if clamp_output:
        rgb = torch.clamp(rgb, 0.0, 1.0)
    return torch.cat([rgb, torch.clamp(rgba[..., 3:4], 0.0, 1.0)], dim=-1)


def error_overlay(rendered_rgb: torch.Tensor, gt_rgb: torch.Tensor) -> torch.Tensor:
    """False-colour per-pixel squared-error map."""
    err = ((rendered_rgb - gt_rgb) ** 2).mean(dim=-1, keepdim=True)
    e = torch.log1p(err * 100.0)
    e = e / torch.clamp(e.max(), min=1e-8)
    r = torch.clamp(1.5 * e - 0.25, 0.0, 1.0)
    g = torch.clamp(1.5 * (1.0 - torch.abs(e - 0.5) * 2.0), 0.0, 1.0)
    b = torch.clamp(1.0 - 1.5 * e, 0.0, 1.0)
    return torch.cat([r, g, b], dim=-1)


def hsv_to_rgb(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Vectorised HSV -> RGB."""
    h = torch.remainder(h, 1.0) * 6.0
    i = torch.floor(h)
    f = h - i
    i = i.to(torch.int64)
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))

    def pick(choices, default):
        out = default
        for k in reversed(range(6)):
            out = torch.where(i == k, choices[k], out)
        return out

    rgb = torch.stack([pick([v, q, p, p, t, v], v), pick([t, v, v, q, p, p], p),
                       pick([p, p, t, v, v, q], q)], dim=-1)
    return torch.where(s[..., None] == 0.0, v[..., None], rgb)


def flow_to_rgb(flow: torch.Tensor) -> torch.Tensor:
    """2-D vector field -> HSV colour wheel: hue = direction, value =
    magnitude."""
    h = torch.atan2(flow[..., 1], flow[..., 0]) / (2.0 * math.pi) + 0.5
    mag = torch.sqrt((flow * flow).sum(dim=-1))
    return hsv_to_rgb(h, torch.ones_like(mag), mag)
