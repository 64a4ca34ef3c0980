"""The plain reference of the fork's irradiance probes: a lattice of probes
inside a box, each marching a lat-long grid of rays outward through the
NeRF (instant-ngp's occupancy-grid march, from t = 0), the radiance
projected onto 9 spherical-harmonic coefficients a colour, and the
irradiance at a surface point from the trilinear blend of the 8 nearest
probes.

The march, instant-ngp's semantics in plain PyTorch:
- a ray starts where it enters the scene's box (near plane 0) and the
  box of the occupied cells, and ends where it leaves them;
- a step is dt = clamp(t * cone_angle, sqrt(3)/1024, sqrt(3)/1024 * 2^7 *
  1024/128); a position is looked up in the occupancy cascade
  max(the smallest cascade holding it, the coarsest whose cells are dt
  wide); an occupied one is a sample (t, dt) and t advances by dt, an
  empty one advances t past the cell, a whole number of steps;
- rays run in rounds of up to 16 samples (48 march steps): each round is
  evaluated (the hash encoding, the density MLP and the colour MLP at the
  configuration's precision) and composited front to back
  (alpha = 1 - exp(-sigma dt), a sample adds only while the transmittance
  before it is at least 0.01, the transmittance is zeroed below 0.01 at the
  end of a round), and a ray stops after the round in which it reached 1024
  samples, or after 96 rounds;
- the probe's radiance is the composited colour over black.

It imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference.field import density_act, mlp, rgb_act, sh4

GRID = 128
MIN_STEP = math.sqrt(3.0) / 1024
MAX_STEP = MIN_STEP * (1 << 7) * 1024 / GRID
MIN_T = 0.01
ROUND_SAMPLES, ROUND_STEPS, MAX_ROUNDS, BUDGET = 16, 48, 96, 1024
SH_C = (0.282095, 0.488603, 1.092548, 0.315392, 0.546274)
SH_A = (math.pi, 2.0 * math.pi / 3.0, math.pi / 4.0)


def _box_times(o, d, lo, hi, signed: bool):
    """Entry and exit t against a box: with `signed` through the inverse of
    the direction, a tiny component replaced by +-1e-12 (the scene box);
    else by division, a tiny component replaced by +1e-12 (the box of
    the occupied cells)."""
    tiny = torch.where(d < 0, -1e-12, 1e-12) if signed else torch.full_like(d, 1e-12)
    safe = torch.where(d.abs() < 1e-12, tiny, d)
    if signed:
        inv = 1.0 / safe
        ta, tb = (lo - o) * inv, (hi - o) * inv
    else:
        ta, tb = (lo - o) / safe, (hi - o) / safe
    return torch.minimum(ta, tb).amax(-1), torch.maximum(ta, tb).amin(-1)


def occupied_box(bitfield: torch.Tensor):
    """The world box of the occupied cells over every cascade."""
    K, G = bitfield.shape[0], bitfield.shape[1]
    idx = torch.arange(G, dtype=torch.float32, device=bitfield.device)
    los, his = [], []
    for c in range(K):
        span = float(2 ** c)
        lo, hi = [], []
        for ax in range(3):
            line = bitfield[c].any(dim=tuple(a for a in range(3) if a != ax))
            lo.append((0.5 - span / 2) + torch.where(line, idx, float(G)).amin() * (span / G))
            hi.append((0.5 - span / 2) + (torch.where(line, idx, -1.0).amax() + 1.0)
                      * (span / G))
        los.append(torch.stack(lo))
        his.append(torch.stack(hi))
    return torch.stack(los).amin(0), torch.stack(his).amax(0)


def _cascade(pos, dt, K: int):
    d = (pos - 0.5).abs().amax(-1)
    by_pos = torch.ceil(torch.log2(torch.clamp(2.0 * d, min=1e-10))).clamp(0, K - 1)
    by_dt = torch.ceil(torch.log2(torch.clamp(dt * GRID, min=1e-10))).clamp(0, K - 1)
    return torch.maximum(by_pos, by_dt).to(torch.int64)


def _occupied(bitfield, pos, mip):
    scale = torch.exp2(mip.float())[:, None]
    cell = torch.floor(((pos - 0.5) / scale + 0.5) * GRID).to(torch.int64)
    inb = ((cell >= 0) & (cell < GRID)).all(-1)
    c = cell.clamp(0, GRID - 1)
    return bitfield[mip, c[:, 0], c[:, 1], c[:, 2]] & inb


def _skip(pos, d, mip, dt):
    """The distance past the current cell, in whole steps of dt."""
    scale = torch.exp2(mip.float())
    p = ((pos - 0.5) / scale[:, None] + 0.5) * GRID
    dg = d * (GRID / scale[:, None])
    flat = dg.abs() < 1e-12
    delta = (torch.floor(p) + (dg > 0).float() - p) / torch.where(flat, 1e-12, dg)
    tau = torch.where(flat, float("inf"), delta).amin(-1)
    tau = torch.clamp(tau, min=0.0) + 1e-5 * scale
    return torch.clamp(torch.ceil(tau / dt), 1.0, 1e6) * dt


def march(field, o, d, bitfield, aabb_scale: float, cone_angle: float):
    """Rays o, d (N, 3), d unit, from t = 0 -> (rgb (N, 3), opacity (N,)).
    `field(unit_pos, dir) -> (rgb, sigma)` evaluates samples."""
    N, dev = o.shape[0], o.device
    K = bitfield.shape[0]
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    lo = torch.full((3,), 0.5 - 0.5 * aabb_scale, device=dev)
    t0, t1 = _box_times(o, d, lo, lo + aabb_scale, True)
    t0 = torch.clamp(t0, min=0.0)
    t1 = torch.maximum(t1, t0)
    blo, bhi = occupied_box(bitfield)
    b0, b1 = _box_times(o, d, blo, bhi, False)
    t0 = torch.maximum(t0, b0)
    t1 = torch.maximum(torch.minimum(t1, b1), t0)
    t, T = t0, torch.ones((N,), device=dev)
    rgb_acc = torch.zeros((N, 3), device=dev)
    op_acc = torch.zeros((N,), device=dev)
    used = torch.zeros((N,), dtype=torch.int64, device=dev)
    slots = torch.arange(ROUND_SAMPLES, device=dev)
    for _ in range(MAX_ROUNDS):
        active = (T >= MIN_T) & (t < t1) & (used < BUDGET)
        if not bool(active.any()):
            break
        ts = torch.zeros((N, ROUND_SAMPLES), device=dev)
        dts = torch.zeros((N, ROUND_SAMPLES), device=dev)
        k = torch.zeros((N,), dtype=torch.int64, device=dev)
        tt = t
        for _ in range(ROUND_STEPS):
            pos = o + tt[:, None] * d
            dt = torch.clamp(tt * cone_angle, MIN_STEP, MAX_STEP)
            mip = _cascade(pos, dt, K)
            live = (tt < t1) & (k < ROUND_SAMPLES)
            emit = live & _occupied(bitfield, pos, mip)
            at = (slots[None] == k[:, None]) & emit[:, None]
            ts = torch.where(at, tt[:, None], ts)
            dts = torch.where(at, dt[:, None], dts)
            skip = _skip(pos, d, mip, dt)
            tt = torch.where(emit, tt + dt, torch.where(live, tt + skip, tt))
            k = k + emit.to(torch.int64)
        k = torch.where(active, k, 0)
        valid = slots[None] < k[:, None]
        pos = o[:, None, :] + ts[..., None] * d[:, None, :]
        unit = ((pos - lo) / aabb_scale).clamp(0.0, 1.0).reshape(-1, 3)
        rgb, sigma = field(unit, d[:, None, :].expand(-1, ROUND_SAMPLES, 3).reshape(-1, 3))
        rgb = rgb.reshape(N, ROUND_SAMPLES, 3)
        sigma = torch.where(valid, sigma.reshape(N, ROUND_SAMPLES), 0.0)
        alpha = torch.where(valid, 1.0 - torch.exp(-sigma * dts), 0.0)
        cum = torch.cumprod(1.0 - alpha, dim=1)
        T_before = torch.cat([torch.ones_like(cum[:, :1]), cum[:, :-1]], dim=1) * T[:, None]
        keep = T_before >= MIN_T
        w = torch.where(keep, alpha * T_before, 0.0)
        T_out = T * torch.where(keep, 1.0 - alpha, 1.0).prod(dim=1)
        T_out = torch.where(T_out < MIN_T, 0.0, T_out)
        rgb_acc = rgb_acc + torch.where(active[:, None], (w[..., None] * rgb).sum(1), 0.0)
        op_acc = op_acc + torch.where(active, w.sum(1), 0.0)
        t = torch.where(active, tt, t)
        T = torch.where(active, T_out, T)
        used = used + k
    return rgb_acc, op_acc


def nerf_field(encode, density_w, rgb_w, precision: str):
    """The field of a NeRF network: unit positions and unit directions ->
    (rgb, sigma)."""
    def field(unit, d):
        d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
        raw = mlp(density_w, encode(unit), precision)
        rgb = rgb_act(mlp(rgb_w, torch.cat([sh4((d + 1.0) * 0.5), raw], dim=-1), precision))
        return rgb, density_act(raw[:, 0])
    return field


def latlong(width: int, height: int, device):
    """(H*W, 3) texel-centre directions and their solid angles."""
    u = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) / width
    v = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) / height
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    theta, phi = (vv - 0.5) * math.pi, (uu - 0.5) * 2.0 * math.pi
    dirs = torch.stack([torch.sin(phi) * torch.cos(theta), torch.sin(theta),
                        torch.cos(phi) * torch.cos(theta)], dim=-1).reshape(-1, 3)
    w = torch.cos((v - 0.5) * math.pi) * (math.pi / height) * (2.0 * math.pi / width)
    return dirs, w[:, None].expand(height, width).reshape(-1)


def sh9(d):
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack([torch.full_like(x, SH_C[0]), SH_C[1] * y, SH_C[1] * z, SH_C[1] * x,
                        SH_C[2] * x * y, SH_C[2] * y * z, SH_C[3] * (3 * z * z - 1.0),
                        SH_C[2] * x * z, SH_C[4] * (x * x - y * y)], dim=-1)


def bake(field, bitfield, aabb_scale, cone_angle, box, grid_size: int, env_width: int,
         env_height: int, chunk: int = 1 << 15) -> dict:
    """The probe lattice: the (grid_size + 2)^3 lattice over the box with
    its ends dropped -> {"coeffs" (G, G, G, 9, 3), "min", "max"}."""
    dev = bitfield.device
    g = grid_size
    lin = [np.linspace(box[0][i], box[1][i], g + 2)[1:-1] for i in range(3)]
    origins = torch.as_tensor(np.stack(np.meshgrid(*lin, indexing="ij"), axis=-1)
                              .reshape(-1, 3).astype(np.float32), device=dev)
    dirs, w = latlong(env_width, env_height, dev)
    P, D = origins.shape[0], dirs.shape[0]
    idx = torch.arange(P * D, device=dev)
    rad = []
    for s in range(0, P * D, chunk):
        i = idx[s:s + chunk]
        rad.append(march(field, origins[i // D], dirs[i % D], bitfield, aabb_scale,
                         cone_angle)[0])
    rad = torch.cat(rad).reshape(P, D, 3).permute(1, 0, 2).reshape(D, P * 3)
    coeffs = ((sh9(dirs) * w[:, None]).T @ rad).reshape(9, P, 3).permute(1, 0, 2)
    return {"coeffs": coeffs.reshape(g, g, g, 9, 3),
            "min": torch.as_tensor(np.asarray(box[0], np.float32), device=dev),
            "max": torch.as_tensor(np.asarray(box[1], np.float32), device=dev)}


def irradiance(probes: dict, pos: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """The probes' SH coefficients blended trilinearly at `pos` (cell
    centres at (i + 0.5) / G of the box), evaluated at `normal` with the
    cosine lobe -> (N, 3), at least 0."""
    c = probes["coeffs"]
    g = c.shape[0]
    rel = (pos - probes["min"]) / torch.clamp(probes["max"] - probes["min"], min=1e-9)
    x = torch.clamp(rel * g - 0.5, 0.0, g - 1.0)
    x0 = torch.floor(x)
    f = x - x0
    x0 = x0.to(torch.int64)
    flat = c.reshape(g ** 3, 27)
    acc = None
    for corner in range(8):
        o = [(corner >> (2 - a)) & 1 for a in range(3)]
        ii = [torch.clamp(x0[:, a] + o[a], 0, g - 1) for a in range(3)]
        wt = None
        for a in range(3):
            wa = f[:, a] if o[a] else 1 - f[:, a]
            wt = wa if wt is None else wt * wa
        term = flat[(ii[0] * g + ii[1]) * g + ii[2]] * wt[:, None]
        acc = term if acc is None else acc + term
    band = torch.tensor([SH_A[0]] + [SH_A[1]] * 3 + [SH_A[2]] * 5, device=pos.device)
    E = ((sh9(normal) * band)[:, :, None] * acc.reshape(-1, 9, 3)).sum(1) / math.pi
    return torch.clamp(E, min=0.0)
