"""Bilinear 2-D texture fetch (port of ops/grids.py::bilinear_sample_2d of
the JAX package), which the irradiance maps read.  The trainable
distortion map waits for Slice C2b of ROADMAP.md."""

from __future__ import annotations

import torch


def bilinear_sample_2d(grid: torch.Tensor, uv: torch.Tensor,
                       align_corners: bool = False) -> torch.Tensor:
    """Sample a (H, W, C) grid at uv (..., 2) in [0,1]^2 (u along W, v
    along H), bilinear, clamped addressing -> (..., C)."""
    H, W = grid.shape[0], grid.shape[1]
    if align_corners:
        x = uv[..., 0] * (W - 1)
        y = uv[..., 1] * (H - 1)
    else:
        x = uv[..., 0] * W - 0.5
        y = uv[..., 1] * H - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0 = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    g = grid.reshape(H * W, -1)
    out = (g[y0 * W + x0] * (1 - fx) * (1 - fy) + g[y0 * W + x1] * fx * (1 - fy)
           + g[y1 * W + x0] * (1 - fx) * fy + g[y1 * W + x1] * fx * fy)
    return out.reshape(uv.shape[:-1] + (grid.shape[-1],))
