"""Pinhole camera math and the lat-long direction maps (port of the
perspective subset of the JAX package's utils/camera.py).

Camera matrices follow the NGP convention: a (3, 4) matrix `[R | t]` whose
columns 0..2 are the camera-frame x/y/z axes in world space and column 3
the camera origin.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from sienerf_torch.common import LensMode


@dataclass(frozen=True)
class Lens:
    mode: LensMode = LensMode.PERSPECTIVE
    # OpenCV: k1 k2 p1 p2; fisheye: k1..k4 (carried from datasets; the
    # camera math takes only the pinhole lens so far)
    params: tuple = field(default_factory=tuple)


def uv_to_ray(uv: torch.Tensor, resolution, focal_length, camera_matrix,
              screen_center=(0.5, 0.5), lens: Lens = Lens()):
    """uv (..., 2) in [0,1]^2 -> (origin (..., 3), direction (..., 3)).

    The direction is not normalised (z = 1 in the camera frame), so depth
    is z-depth along the view axis.  Only the pinhole lens is ported."""
    if lens.mode != LensMode.PERSPECTIVE:
        raise NotImplementedError(f"lens {lens.mode} is not ported yet")
    dev = uv.device
    cam = torch.as_tensor(np.asarray(camera_matrix, np.float32), device=dev)
    res = np.asarray(resolution, np.float32)
    fl = np.asarray(focal_length, np.float32)
    sc = np.asarray(screen_center, np.float32)
    # the same f32 operation order as the reference: (u - c) * res / f
    x = (uv[..., 0] - float(sc[0])) * float(res[0]) / float(fl[0])
    y = (uv[..., 1] - float(sc[1])) * float(res[1]) / float(fl[1])
    # R @ (x, y, 1) as explicit f32 products: a matmul could run in TF32
    rot = cam[:3, :3]
    direction = torch.stack(
        [rot[r, 0] * x + rot[r, 1] * y + rot[r, 2] for r in range(3)], dim=-1)
    origin = cam[:3, 3].expand(direction.shape)
    return origin, direction


def look_at_matrix(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """NGP-convention (3, 4) camera matrix looking from `eye` to `target`."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


def latlong_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Lat-long texture coordinates in [0,1] -> unit directions (..., 3)."""
    theta = (v - 0.5) * math.pi
    phi = (u - 0.5) * 2.0 * math.pi
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([sp * ct, st, cp * ct], dim=-1)


def dir_to_latlong_uv(d: torch.Tensor) -> torch.Tensor:
    """Inverse of latlong_to_dir; d (..., 3) need not be normalised."""
    d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    theta = torch.arcsin(torch.clamp(d[..., 1], -1.0, 1.0))
    phi = torch.atan2(d[..., 0], d[..., 2])
    return torch.stack([phi / (2.0 * math.pi) + 0.5, theta / math.pi + 0.5], dim=-1)
