"""Ground-truth signed distance from a triangle BVH on the device (port of
the JAX package's geom/sdf_gt.py): the unsigned distance is the BVH's
closest point; the sign is the parity of one fixed stab ray (watertight),
whether any of 32 Fibonacci stab rays escapes (raystab), or whether more
than 2 of 32 random walks of 4 cosine bounces escape (path escape, for
open or leaky meshes).

The SDF engine's default ground truth is the native host query
(geom/bvh_native.py::sdf_query); these device walks are the path an engine
made with host_gt=False takes, and what the tests hold both to."""

from __future__ import annotations

import math

import numpy as np
import torch

from sienerf_torch.common import MeshSdfMode
from sienerf_torch.geom.bvh import bvh_closest_point, bvh_count_hits, bvh_raytrace
from sienerf_torch.ops.samplers import fibonacci_sphere_dirs

_WATERTIGHT_DIR = np.asarray([0.48362, 0.62426, 0.61292], np.float32)
_N_STAB = 32


def unsigned_distance(bvh_dev: dict, points: torch.Tensor):
    """-> (distance (N,), triangle id (N,), closest point (N, 3))."""
    return bvh_closest_point(bvh_dev, points)


def sign_watertight(bvh_dev: dict, points: torch.Tensor) -> torch.Tensor:
    """+1 outside, -1 inside, by the parity of one stab ray."""
    d = torch.as_tensor(_WATERTIGHT_DIR, device=points.device).expand(points.shape)
    count = bvh_count_hits(bvh_dev, points, d)
    return torch.where(count % 2 == 0, 1.0, -1.0)


def sign_raystab(bvh_dev: dict, points: torch.Tensor, n_dirs: int = _N_STAB) -> torch.Tensor:
    """+1 where any of n_dirs Fibonacci stab rays escapes the mesh."""
    dirs = torch.as_tensor(fibonacci_sphere_dirs(n_dirs), device=points.device)
    escaped = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
    for i in range(n_dirs):
        tid = bvh_raytrace(bvh_dev, points, dirs[i].expand(points.shape))[1]
        escaped = escaped | (tid < 0)
    return torch.where(escaped, 1.0, -1.0)


def _cosine_dir(u: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """A cosine-weighted direction around `normal` (N, 3) from uniforms u
    (N, 2), in the reference's orthonormal basis (the binormal from the
    larger of |n.x| and |n.z|)."""
    phi = 2.0 * math.pi * u[..., 0]
    sz = torch.sqrt(u[..., 1])
    sr = torch.sqrt(torch.clamp(1.0 - u[..., 1], min=0.0))
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    zero = torch.zeros_like(nx)
    binormal = torch.where((nx.abs() > nz.abs())[..., None],
                           torch.stack([-ny, nx, zero], dim=-1),
                           torch.stack([zero, -nz, ny], dim=-1))
    binormal = binormal / torch.clamp(torch.linalg.norm(binormal, dim=-1, keepdim=True),
                                      min=1e-12)
    tangent = torch.linalg.cross(binormal, normal)
    return ((sr * torch.cos(phi))[..., None] * tangent
            + (sr * torch.sin(phi))[..., None] * binormal + sz[..., None] * normal)


def sign_pathescape(bvh_dev: dict, points: torch.Tensor, generator: torch.Generator | None = None,
                    n_paths: int = 32, n_bounces: int = 4, draw=None) -> torch.Tensor:
    """+1 where more than 2 of n_paths random walks escape the mesh.  A
    walk starts in a uniform direction; at a hit it restarts 1e-3 short of
    the surface in a cosine direction around the face-forward normal; a
    walk that misses has escaped.  Its uniforms come from
    `draw(path, bounce, (N, 2))` (bounce -1: the start direction), by
    default from `generator`."""
    N, dev = points.shape[0], points.device
    if draw is None:
        def draw(_path, _bounce, shape):
            return torch.rand(shape, generator=generator, device=dev)
    n_escaped = torch.zeros(N, dtype=torch.int64, device=dev)
    for p in range(n_paths):
        u = draw(p, -1, (N, 2))
        z = 2.0 * u[:, 0] - 1.0
        r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        phi = 2.0 * math.pi * u[:, 1]
        d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
        origin = points
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        escaped = torch.zeros(N, dtype=torch.bool, device=dev)
        for j in range(n_bounces):
            t, tid, _, _ = bvh_raytrace(bvh_dev, origin, d)
            miss = tid < 0
            escaped = escaped | (alive & miss)
            still = alive & ~miss
            safe = torch.clamp(tid, min=0)
            n0 = torch.linalg.cross(bvh_dev["tri_ab"][safe], bvh_dev["tri_ac"][safe])
            n0 = n0 / torch.clamp(torch.linalg.norm(n0, dim=-1, keepdim=True), min=1e-12)
            n = torch.where((d * n0).sum(dim=-1, keepdim=True) > 0, -n0, n0)
            origin = torch.where(still[:, None],
                                 origin + d * torch.clamp(t - 1e-3, min=0.0)[:, None], origin)
            d = torch.where(still[:, None], _cosine_dir(draw(p, j, (N, 2)), n), d)
            alive = still
        n_escaped = n_escaped + escaped.to(torch.int64)
    return torch.where(n_escaped > 2, 1.0, -1.0)


def signed_distance(bvh_dev: dict, points: torch.Tensor,
                    mode: MeshSdfMode = MeshSdfMode.WATERTIGHT,
                    generator: torch.Generator | None = None, draw=None) -> torch.Tensor:
    """Signed distance (N,) of points (N, 3): negative inside."""
    dist = unsigned_distance(bvh_dev, points)[0]
    if mode == MeshSdfMode.WATERTIGHT:
        s = sign_watertight(bvh_dev, points)
    elif mode == MeshSdfMode.PATH_ESCAPE:
        s = sign_pathescape(bvh_dev, points, generator, draw=draw)
    else:
        s = sign_raystab(bvh_dev, points)
    return dist * s
