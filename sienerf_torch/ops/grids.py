"""Texture fetches (port of the JAX package's ops/grids.py): bilinear and
nearest 2-D (the irradiance maps, the image trainer's targets, the
trainable distortion map) and trilinear 3-D (the volume mode's density
grid).  The bilinear fetch is differentiable in the grid and in uv; its
grid gradient, the distortion map's splat, sums each texel's shares in a
fixed order (ops/fixed_order.py::take_rows)."""

from __future__ import annotations

import torch

from sienerf_torch.ops.fixed_order import take_rows


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
    corners = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], dim=-1)
    f = take_rows(grid.reshape(H * W, -1), corners)  # (..., 4, C)
    out = (f[..., 0, :] * (1 - fx) * (1 - fy) + f[..., 1, :] * fx * (1 - fy)
           + f[..., 2, :] * (1 - fx) * fy + f[..., 3, :] * fx * fy)
    return out.reshape(uv.shape[:-1] + (grid.shape[-1],))


def nearest_sample_2d(grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """The texel of a (H, W, C) grid under uv (..., 2) in [0,1]^2 -> (..., C)."""
    H, W = grid.shape[0], grid.shape[1]
    x = torch.clamp((uv[..., 0] * W).to(torch.int64), 0, W - 1)
    y = torch.clamp((uv[..., 1] * H).to(torch.int64), 0, H - 1)
    return grid.reshape(H * W, -1)[y * W + x].reshape(uv.shape[:-1] + (grid.shape[-1],))


def trilinear_sample_3d(grid: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Sample a (D, H, W, C) grid at pos (..., 3) in [0,1]^3 (x along W, y
    along H, z along D), clamped, cell-centred -> (..., C).  The eight
    corners are summed in the reference's order."""
    D, H, W = grid.shape[0], grid.shape[1], grid.shape[2]
    x = pos[..., 0] * W - 0.5
    y = pos[..., 1] * H - 0.5
    z = pos[..., 2] * D - 0.5
    x0, y0, z0 = torch.floor(x), torch.floor(y), torch.floor(z)
    fx, fy, fz = x - x0, y - y0, z - z0
    xi0, yi0, zi0 = x0.to(torch.int64), y0.to(torch.int64), z0.to(torch.int64)
    g = grid.reshape(D * H * W, -1)
    out = None
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi = torch.clamp(xi0 + dx, 0, W - 1)
                yi = torch.clamp(yi0 + dy, 0, H - 1)
                zi = torch.clamp(zi0 + dz, 0, D - 1)
                w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                     * (fz if dz else 1 - fz))[..., None]
                f = g[(zi * H + yi) * W + xi]
                out = f * w if out is None else out + f * w
    return out.reshape(pos.shape[:-1] + (grid.shape[-1],))
