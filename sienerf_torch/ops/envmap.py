"""The trainable lat-long environment map (port of the JAX package's
ops/envmap.py): the map's bilinear read, with longitude wrapping and
latitude clamped, and the background composited behind the map.  The read
is differentiable in the map and in the directions; the map's gradient,
the reference's 4-texel splat, sums each texel's shares in a fixed order
(ops/fixed_order.py::take_rows).  The alpha channel takes no gradient."""

from __future__ import annotations

import math

import torch

from sienerf_torch.ops.fixed_order import take_rows


def dir_to_latlong_uv(dirs: torch.Tensor) -> torch.Tensor:
    """(N, 3) unit directions -> (N, 2) in [0,1]^2 (u = latitude row from
    world +y, v = longitude, phi = atan2(-x, z)), the reference's
    permutation of its spherical read."""
    theta = torch.arccos(torch.clamp(dirs[:, 1], -1.0, 1.0))
    phi = torch.atan2(-dirs[:, 0], dirs[:, 2])
    return torch.stack([theta / math.pi, phi / (2.0 * math.pi) + 0.5], dim=-1)


def read_envmap(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear lat-long read: envmap (H, W, 4), dirs (N, 3) unit -> (N, 4).
    Longitude (x) wraps, latitude (y) clamps."""
    H, W = envmap.shape[0], envmap.shape[1]
    uv = dir_to_latlong_uv(dirs)
    fx = uv[:, 1] * (W - 1)
    fy = uv[:, 0] * (H - 1)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]

    def at(xi, yi):
        xi = torch.where(xi < 0, xi + W, torch.where(xi >= W, xi - W, xi))
        yi = torch.clamp(yi, 0, H - 1)
        return yi * W + xi

    corners = torch.stack([at(x0, y0), at(x0 + 1, y0), at(x0, y0 + 1), at(x0 + 1, y0 + 1)],
                          dim=-1)
    f = take_rows(envmap.reshape(H * W, -1), corners)  # (N, 4, 4)
    return ((1 - wx) * (1 - wy) * f[:, 0] + wx * (1 - wy) * f[:, 1]
            + (1 - wx) * wy * f[:, 2] + wx * wy * f[:, 3])


def background_behind_envmap(envmap: torch.Tensor, dirs: torch.Tensor,
                             bg: torch.Tensor) -> torch.Tensor:
    """A background colour composited behind the envmap:
    env.rgb + bg * (1 - env.a).  bg (N, 3) or (3,) -> (N, 3)."""
    ev = read_envmap(envmap, dirs)
    return ev[:, :3] + bg.expand(ev[:, :3].shape) * (1.0 - ev[:, 3:4].detach())
