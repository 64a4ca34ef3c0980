"""Surface irradiance gathered from a NeRF (port of the JAX package's
engines/irradiance.py), the fork's aim: the ambient light a mesh inside a
NeRF scene receives.

1. `render_envmap`: march a lat-long grid of rays outward from a probe
   origin through the NeRF -> a radiance environment map.
2. `render_envmap_multi`: the mean over Halton-jittered origins.
3. `bake_probe_grid`: a G^3 lattice of probes over a box, every probe's
   envmap projected onto 9 spherical-harmonic coefficients a channel, so
   that the grid interpolates trilinearly and stays small.
4. `sample_envmap_irradiance` and `sample_probe_grid` give the BRDF's
   ambient term.

The probe rays of a whole lattice are marched as one ray batch
(`_march_probe_rays`) through the live renderer's `render_rays` with the
near plane at 0.  The SH projections and the envmap convolution are f32
products in full f32 (TF32 off), as the reference's run at
Precision.HIGHEST.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sienerf_torch.geom.bvh import _full_f32_matmul
from sienerf_torch.ops.grids import bilinear_sample_2d
from sienerf_torch.ops.optim import inference_params
from sienerf_torch.ops.samplers import halton_2d
from sienerf_torch.utils.camera import dir_to_latlong_uv, latlong_to_dir
from sienerf_torch.utils.device_inputs import constant


def _latlong_dirs(width: int, height: int, device=None) -> torch.Tensor:
    """(H*W, 3) directions of the envmap's texel centres."""
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    return latlong_to_dir(uu, vv).reshape(-1, 3)


def _latlong_solid_angles(width: int, height: int, device=None) -> torch.Tensor:
    """Per-texel solid angle: cos(theta) * (pi / H) * (2 pi / W)."""
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    theta = (v - 0.5) * math.pi
    w = torch.cos(theta) * (math.pi / height) * (2.0 * math.pi / width)
    return w[:, None].expand(height, width).reshape(-1)


def _state_params(state: dict):
    return inference_params(state.get("opt") or {}, state["params"]), \
        state["occ"]["bitfield"]


def _march_probe_rays(nerf_engine, params, bf, origins, dirs,
                      chunk: int = 1 << 15) -> torch.Tensor:
    """March every (probe origin (P, 3), direction (D, 3)) pair as one flat
    ray batch, `chunk` rays at a time -> (P, D, 4) radiance and opacity."""
    P, D = origins.shape[0], dirs.shape[0]
    n = P * D
    idx = torch.arange(n, device=dirs.device)
    o_all = origins[idx // D]
    d_all = dirs[idx % D]
    rgbs, ops = [], []
    for s in range(0, n, chunk):
        rgb, op, _ = nerf_engine.render_rays(params, bf, o_all[s:s + chunk],
                                             d_all[s:s + chunk], near=0.0)
        rgbs.append(rgb)
        ops.append(op)
    return torch.cat([torch.cat(rgbs), torch.cat(ops)[:, None]], dim=-1).reshape(P, D, 4)


def render_envmap(nerf_engine, state, origin, width: int = 64, height: int = 32,
                  chunk: int = 8192) -> torch.Tensor:
    """March the NeRF outward from `origin` along a lat-long grid of
    directions -> (H, W, 4) radiance and opacity."""
    params, bf = _state_params(state)
    dev = bf.device
    dirs = _latlong_dirs(width, height, dev)
    origin = torch.as_tensor(np.asarray(origin, np.float32), device=dev).reshape(1, 3)
    return _march_probe_rays(nerf_engine, params, bf, origin, dirs, chunk).reshape(
        height, width, 4)


def render_envmap_multi(nerf_engine, state, origin, n_origins: int = 8,
                        radius: float = 0.05, width: int = 64,
                        height: int = 32) -> torch.Tensor:
    """The mean envmap over `n_origins` Halton points on a sphere of
    `radius` around `origin` -> (H, W, 4)."""
    h2 = halton_2d(np.arange(1, n_origins + 1)).astype(np.float64)
    phi = 2 * np.pi * h2[:, 0]
    ct = 2 * h2[:, 1] - 1
    st = np.sqrt(np.maximum(1 - ct * ct, 0))
    offsets = radius * np.stack([np.cos(phi) * st, np.sin(phi) * st, ct], axis=-1)
    params, bf = _state_params(state)
    dev = bf.device
    origins = torch.as_tensor((np.asarray(origin, np.float32) + offsets).astype(np.float32),
                              device=dev)
    em = _march_probe_rays(nerf_engine, params, bf, origins,
                           _latlong_dirs(width, height, dev))
    return em.mean(dim=0).reshape(height, width, 4)


# --- irradiance from an envmap ------------------------------------------------


def irradiance_from_envmap(envmap: torch.Tensor) -> torch.Tensor:
    """Diffuse convolution of a radiance envmap (H, W, 4):
    E(n) = sum_w L(w) max(0, n.w) dOmega / pi -> (H, W, 3), indexed by the
    normal's direction."""
    H, W = envmap.shape[:2]
    dev = envmap.device
    dirs = _latlong_dirs(W, H, dev)
    weighted = envmap.reshape(-1, 4)[:, :3] * _latlong_solid_angles(W, H, dev)[:, None]
    with _full_f32_matmul():
        cos = torch.clamp(dirs @ dirs.T, min=0.0)
        E = (cos @ weighted) / math.pi
    return E.reshape(H, W, 3)


def sample_envmap_irradiance(irradiance_map: torch.Tensor,
                             normals: torch.Tensor) -> torch.Tensor:
    """Ambient term for surface normals from a convolved irradiance map."""
    return bilinear_sample_2d(irradiance_map[..., :3], dir_to_latlong_uv(normals))


# --- the SH probe grid ----------------------------------------------------------

_SH_C = (0.282095, 0.488603, 1.092548, 0.315392, 0.546274)
_SH_A = (math.pi, 2.0 * math.pi / 3.0, math.pi / 4.0)  # cosine-lobe convolution


def sh9_basis(d: torch.Tensor) -> torch.Tensor:
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([torch.full_like(x, _SH_C[0]), _SH_C[1] * y, _SH_C[1] * z,
                        _SH_C[1] * x, _SH_C[2] * x * y, _SH_C[2] * y * z,
                        _SH_C[3] * (3 * z * z - 1.0), _SH_C[2] * x * z,
                        _SH_C[4] * (x * x - y * y)], dim=-1)


def sh_project_envmap(envmap: torch.Tensor) -> torch.Tensor:
    """Radiance envmap (H, W, 4) -> (9, 3) SH coefficients."""
    H, W = envmap.shape[:2]
    dev = envmap.device
    dirs = _latlong_dirs(W, H, dev)
    Y = sh9_basis(dirs) * _latlong_solid_angles(W, H, dev)[:, None]
    with _full_f32_matmul():
        return Y.T @ envmap.reshape(-1, 4)[:, :3]


def _sh_band_weights(device) -> torch.Tensor:
    return constant(np.asarray([_SH_A[0]] + [_SH_A[1]] * 3 + [_SH_A[2]] * 5, np.float32),
                    device)


def sh_irradiance(coeffs: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Irradiance for normals (..., 3) from SH radiance coefficients
    (..., 9, 3) -> (..., 3), clamped at 0."""
    Y = sh9_basis(normals) * _sh_band_weights(normals.device)
    E = (Y[..., :, None] * coeffs).sum(dim=-2) / math.pi
    return torch.clamp(E, min=0.0)


def bake_probe_grid(nerf_engine, state, aabb_min, aabb_max, grid_size: int = 4,
                    env_width: int = 32, env_height: int = 16,
                    center_offset=(0.0, 0.0, 0.0)) -> dict:
    """A grid_size^3 lattice of probes inside the box (the lattice's cell
    centres of a (grid_size + 2)^3 spacing, ends dropped), each baked to SH
    irradiance coefficients -> {"coeffs": (G, G, G, 9, 3), "min", "max"}.
    `center_offset` moves the probes into the NeRF's own frame."""
    g = grid_size
    lin = [np.linspace(aabb_min[i], aabb_max[i], g + 2)[1:-1] for i in range(3)]
    gx, gy, gz = np.meshgrid(lin[0], lin[1], lin[2], indexing="ij")
    origins = (np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
               - np.asarray(center_offset, np.float32))
    params, bf = _state_params(state)
    dev = bf.device
    dirs = _latlong_dirs(env_width, env_height, dev)
    ems = _march_probe_rays(nerf_engine, params, bf, torch.as_tensor(origins, device=dev),
                            dirs)  # (g^3, HW, 4)
    Y = sh9_basis(dirs) * _latlong_solid_angles(env_width, env_height, dev)[:, None]
    rad = ems[..., :3].permute(1, 0, 2).reshape(dirs.shape[0], -1)  # (HW, P*3)
    with _full_f32_matmul():
        coeffs = (Y.T @ rad).reshape(9, -1, 3).permute(1, 0, 2)
    return {"coeffs": coeffs.reshape(g, g, g, 9, 3).contiguous(),
            "min": torch.as_tensor(np.asarray(aabb_min, np.float32), device=dev),
            "max": torch.as_tensor(np.asarray(aabb_max, np.float32), device=dev)}


def sample_probe_grid(probe_grid: dict, pos: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Trilinear blend of the probes' SH coefficients at `pos`, evaluated
    at `normals` -> (..., 3)."""
    coeffs = probe_grid["coeffs"]
    g = coeffs.shape[0]
    lo, hi = probe_grid["min"], probe_grid["max"]
    rel = (pos - lo) / torch.clamp(hi - lo, min=1e-9)
    x = torch.clamp(rel * g - 0.5, 0.0, g - 1.0)
    x0 = torch.floor(x)
    f = x - x0
    x0 = x0.to(torch.int64)
    flat = coeffs.reshape(g * g * g, 27)
    out = None
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                xi = torch.clamp(x0[..., 0] + dx, 0, g - 1)
                yi = torch.clamp(x0[..., 1] + dy, 0, g - 1)
                zi = torch.clamp(x0[..., 2] + dz, 0, g - 1)
                w = ((f[..., 0] if dx else 1 - f[..., 0]) * (f[..., 1] if dy else 1 - f[..., 1])
                     * (f[..., 2] if dz else 1 - f[..., 2]))
                c = flat[(xi * g + yi) * g + zi]
                out = c * w[..., None] if out is None else out + c * w[..., None]
    return sh_irradiance(out.reshape(pos.shape[:-1] + (9, 3)), normals)
