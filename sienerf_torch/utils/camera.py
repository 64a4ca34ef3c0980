"""Camera and lens math (port of the JAX package's utils/camera.py): field
of view <-> focal length, pixel -> ray for every lens model (pinhole,
OpenCV and OpenCV-fisheye undistortion, F-theta, lat-long,
equirectangular), the trainable
distortion map's offset, the lat-long direction maps, and the camera slerp
of rolling shutter and motion blur.

Camera matrices follow the NGP convention: a (3, 4) matrix `[R | t]` whose
columns 0..2 are the camera-frame x/y/z axes in world space and column 3
the camera origin.  Every rotation of a direction is written as explicit
f32 products and sums, never a matmul that could run in TF32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from sienerf_torch.common import LensMode
from sienerf_torch.utils.device_inputs import upload


@dataclass(frozen=True)
class Lens:
    mode: LensMode = LensMode.PERSPECTIVE
    # OpenCV: k1 k2 p1 p2; fisheye: k1..k4; F-theta: r0..r4, resx, resy
    params: tuple = field(default_factory=tuple)

    @property
    def is_distorted(self) -> bool:
        return self.mode != LensMode.PERSPECTIVE and len(self.params) > 0


def fov_to_focal_length(resolution: float, degrees: float) -> float:
    """The focal length in pixels of a field of view of `degrees` across
    `resolution` pixels."""
    return 0.5 * resolution / math.tan(0.5 * math.radians(degrees))


def focal_length_to_fov(resolution: float, focal_length: float) -> float:
    """The field of view in degrees of `focal_length` pixels across
    `resolution` pixels (the inverse of fov_to_focal_length)."""
    return 2.0 * math.degrees(math.atan(0.5 * resolution / focal_length))


def opencv_lens_distortion_delta(params, x, y):
    """Forward OpenCV radial and tangential distortion of (x, y)."""
    k1, k2, p1, p2 = params[0], params[1], params[2], params[3]
    r2 = x * x + y * y
    radial = k1 * r2 + k2 * r2 * r2
    du = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dv = y * radial + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return du, dv


def iterative_opencv_lens_undistortion(params, x, y, n_iters: int = 8):
    """Fixed-point inversion of the OpenCV distortion model."""
    xd, yd = x, y
    for _ in range(n_iters):
        du, dv = opencv_lens_distortion_delta(params, x, y)
        x = xd - du
        y = yd - dv
    return x, y


def opencv_fisheye_distortion_delta(params, x, y):
    k1, k2, k3, k4 = params[0], params[1], params[2], params[3]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(r > 1e-8, theta_d / torch.clamp(r, min=1e-8), 1.0)
    return x * scale - x, y * scale - y


def iterative_opencv_fisheye_undistortion(params, x, y, n_iters: int = 8):
    xd, yd = x, y
    for _ in range(n_iters):
        du, dv = opencv_fisheye_distortion_delta(params, x, y)
        x = xd - du
        y = yd - dv
    return x, y


def undistort(lens: Lens, x, y):
    """Camera-plane (x, y) of a pixel -> the undistorted plane point of the
    OpenCV and OpenCV-fisheye lenses (8 fixed-point iterations); other
    lenses pass it through."""
    if lens.mode == LensMode.OPENCV and lens.is_distorted:
        return iterative_opencv_lens_undistortion(lens.params, x, y)
    if lens.mode == LensMode.OPENCV_FISHEYE and lens.is_distorted:
        return iterative_opencv_fisheye_undistortion(lens.params, x, y)
    return x, y


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


def equirectangular_to_dir(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    ct = (v - 0.5) * 2.0
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = (u - 0.5) * 2.0 * math.pi
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([sp * st, ct, cp * st], dim=-1)


def f_theta_undistortion(params, u, v) -> torch.Tensor:
    """The r-polynomial fisheye: params r0..r4, resx, resy -> camera-frame
    directions (..., 3)."""
    xpix = u * params[5]
    ypix = v * params[6]
    norm = torch.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[0] + norm * (params[1] + norm * (params[2] + norm * (params[3]
                                                                        + norm * params[4])))
    sa, ca = torch.sin(alpha), torch.cos(alpha)
    inv_norm = torch.where(norm > 0, 1.0 / torch.clamp(norm, min=1e-12), 0.0)
    s = sa * inv_norm
    return torch.stack([s * xpix, s * ypix, ca], dim=-1)


def rotate(rot: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """rot (..., 3, 3) applied to d (..., 3) as explicit f32 products and
    sums (a matmul could run in TF32)."""
    return torch.stack([rot[..., r, 0] * d[..., 0] + rot[..., r, 1] * d[..., 1]
                        + rot[..., r, 2] * d[..., 2] for r in range(3)], dim=-1)


def uv_to_ray(uv: torch.Tensor, resolution, focal_length, camera_matrix,
              screen_center=(0.5, 0.5), lens: Lens = Lens(), distortion_grid=None):
    """uv (..., 2) in [0,1]^2 -> (origin (..., 3), direction (..., 3)).

    The direction is not normalised (z = 1 in the camera frame for the
    plane lenses), so depth is z-depth along the view axis.
    `distortion_grid`, a (R, R, 2) map, adds its bilinear value at uv to
    the camera-frame x and y."""
    dev = uv.device
    cam = upload(np.asarray(camera_matrix, np.float32), dev)
    res = np.asarray(resolution, np.float32)
    fl = np.asarray(focal_length, np.float32)
    sc = np.asarray(screen_center, np.float32)
    u, v = uv[..., 0], uv[..., 1]
    if lens.mode == LensMode.FTHETA:
        dir_cam = f_theta_undistortion(lens.params, u - float(sc[0]), v - float(sc[1]))
    elif lens.mode == LensMode.LATLONG:
        dir_cam = latlong_to_dir(u, v)
    elif lens.mode == LensMode.EQUIRECTANGULAR:
        dir_cam = equirectangular_to_dir(u, v)
    else:
        # the same f32 operation order as the reference: (u - c) * res / f
        x = (u - float(sc[0])) * float(res[0]) / float(fl[0])
        y = (v - float(sc[1])) * float(res[1]) / float(fl[1])
        x, y = undistort(lens, x, y)
        dir_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if distortion_grid is not None:
        from sienerf_torch.ops.grids import bilinear_sample_2d

        delta = bilinear_sample_2d(distortion_grid, uv)
        dir_cam = torch.cat([dir_cam[..., :2] + delta, dir_cam[..., 2:]], dim=-1)
    direction = rotate(cam[:3, :3], dir_cam)
    origin = cam[:3, 3].expand(direction.shape)
    return origin, direction


def pixel_grid_uv(width: int, height: int, device=None) -> torch.Tensor:
    """uv of every pixel centre of a frame -> (H, W, 2)."""
    x = torch.arange(width, dtype=torch.float32, device=device)
    y = torch.arange(height, dtype=torch.float32, device=device)
    py, px = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([(px + 0.5) / width, (py + 0.5) / height], dim=-1)


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


def rotation_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotations -> (..., 4) unit quaternions (w, x, y, z), by
    the branchless Shepperd form: each component from its own pivot, the
    signs from the off-diagonal differences."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 0.5
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 0.5
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 0.5
    qx = torch.copysign(qx, m21 - m12)
    qy = torch.copysign(qy, m02 - m20)
    qz = torch.copysign(qz, m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.sqrt((q * q).sum(dim=-1, keepdim=True))


def quat_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternions (w, x, y, z) -> (..., 3, 3) rotations."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                       dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                       dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                       dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def camera_slerp(xf_a: torch.Tensor, xf_b: torch.Tensor, t) -> torch.Tensor:
    """Slerp between (..., 3, 4) camera matrices at t (...,): the rotation
    along the shortest arc, the translation linearly, in the cameras'
    dtype.  The camera of a pixel under rolling shutter and motion blur."""
    t = torch.as_tensor(t, device=xf_a.device).to(xf_a.dtype)[..., None]
    qa = rotation_to_quat(xf_a[..., :3, :3])
    qb = rotation_to_quat(xf_b[..., :3, :3])
    dot = (qa * qb).sum(dim=-1, keepdim=True)
    qb = torch.where(dot < 0, -qb, qb)
    dot = dot.abs()
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    small = sin_theta < 1e-5
    safe = torch.where(small, 1.0, sin_theta)
    wa = torch.where(small, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    wb = torch.where(small, t, torch.sin(t * theta) / safe)
    q = wa * qa + wb * qb
    q = q / torch.sqrt((q * q).sum(dim=-1, keepdim=True))
    R = quat_to_rotation(q)
    trans = xf_a[..., :3, 3] * (1.0 - t) + xf_b[..., :3, 3] * t
    return torch.cat([R, trans[..., None]], dim=-1)
