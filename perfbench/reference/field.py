"""The plain reference of the NeRF field and of its bake, in plain PyTorch.

- The hash-grid encoding (tcnn's semantics, "cell" table layout: one row a
  cell holding its 8 corner vectors), forward only, from an f32 table or
  from an e4m3 table with one scale a level.
- The MLPs at the precision a configuration states: each layer's input and
  weights rounded to bf16, products summed in f32 ("bf16"), or the same
  with per-tensor scaled e4m3 operands ("fp8", the control's precision).
- The SH basis of degree 4 and the output activations (logistic colour,
  exponential density).
- The bake: the density MLP at every vertex of one (R+1)^3 lattice a
  cascade, culled by the 3^3-dilated occupancy grid, quantised to int16
  rows with one scale a (cascade, feature) from evenly spaced probes.

Written from the published semantics and the program's documented
numerics; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF
E4M3_MAX = 448.0
SCALE_PROBES = 1 << 18              # vertices probed a cascade for the row scale
CHUNK = 1 << 19                     # vertices evaluated at a time


# --- hash grid ---------------------------------------------------------------


def grid_levels(n_levels: int, log2_table: int, base_resolution: int, per_level_scale):
    """Per-level (f32 scale, resolution, dense, (3,) index multipliers)."""
    table = 1 << log2_table
    out = []
    for level in range(n_levels):
        scale = base_resolution * per_level_scale ** level - 1.0
        res = int(math.ceil(scale)) + 1
        dense = max(res - 1, 1) ** 3 <= table
        if dense:
            s, mult = 1, []
            for _ in range(3):
                mult.append(s % (1 << 32))
                s *= max(res - 1, 1)
        else:
            mult = [p % (1 << 32) for p in PRIMES]
        out.append((np.float32(scale), res, dense, mult))
    return out


def grid_spec(encoding: dict, aabb_scale: float) -> dict:
    """A tcnn HashGrid encoding dict -> the sizes the encode needs.  Without
    per_level_scale the finest level spans 2048 * aabb_scale cells."""
    L = int(encoding.get("n_levels", 16))
    base = int(encoding.get("base_resolution", 16))
    pls = encoding.get("per_level_scale")
    if pls is None:
        pls = float(np.exp(np.log(2048.0 * aabb_scale / base) / max(L - 1, 1)))
    log2 = int(encoding.get("log2_hashmap_size", 19))
    return {"levels": grid_levels(L, log2, base, float(pls)), "table": 1 << log2,
            "F": int(encoding.get("n_features_per_level", 2))}


def hash_encode(spec: dict, rows_of_level, pos: torch.Tensor) -> torch.Tensor:
    """pos (N, 3) in [0,1]^3 -> (N, L*F) f32.  `rows_of_level(l, idx)`
    gives level l's cell rows idx as (N, 8, F) f32."""
    outs = []
    dev = pos.device
    offs = torch.tensor([[(c >> d) & 1 for d in range(3)] for c in range(8)],
                        dtype=torch.bool, device=dev)
    for level, (scale, res, dense, mult) in enumerate(spec["levels"]):
        x = pos.float() * float(scale) + 0.5
        x_floor = torch.floor(x)
        frac = x - x_floor
        base = torch.clamp(x_floor, min=0.0).clamp(max=float(max(res - 2, 0))).to(torch.int64)
        idx = None
        for d in range(3):
            term = (base[:, d] * mult[d]) & U32
            if idx is None:
                idx = term
            elif dense:
                idx = (idx + term) & U32
            else:
                idx = idx ^ term
        idx = idx & (spec["table"] - 1)
        per_dim = torch.where(offs[None], frac[:, None, :], 1.0 - frac[:, None, :])
        w = per_dim[..., 0] * per_dim[..., 1] * per_dim[..., 2]  # (N, 8)
        outs.append((rows_of_level(level, idx) * w[..., None]).sum(dim=1))
    return torch.stack(outs, dim=1).reshape(pos.shape[0], -1)


def fp8_rows(table: torch.Tensor, scale: torch.Tensor, F_: int):
    """Rows reader of an e4m3 table, uint8 (L, T, 8*F), scale (L,)."""
    def rows(level, idx):
        r = table[level].index_select(0, idx).view(torch.float8_e4m3fn).float()
        return r.reshape(-1, 8, F_) * scale[level]
    return rows


def f32_rows(table: torch.Tensor, F_: int):
    """Rows reader of an f32 table (L, T, 8, F)."""
    flat = table.reshape(table.shape[0], table.shape[1], 8 * F_)

    def rows(level, idx):
        return flat[level].index_select(0, idx).reshape(-1, 8, F_)
    return rows


# --- MLPs ----------------------------------------------------------------------


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to the operand precision: bf16, or e4m3 with one scale for
    the tensor (its absolute maximum at the format's largest value)."""
    if precision == "bf16":
        return x.to(torch.bfloat16).float()
    if precision == "fp8":
        s = torch.clamp(x.abs().amax(), min=1e-30) / E4M3_MAX
        return (x / s).clamp(-E4M3_MAX, E4M3_MAX).to(torch.float8_e4m3fn).float() * s
    raise ValueError(f"unknown precision {precision!r}")


def mlp(weights, x: torch.Tensor, precision: str = "bf16") -> torch.Tensor:
    """Bias-free ReLU MLP, no output activation: operands rounded to
    `precision`, products summed in f32."""
    h = round_to(x, precision)
    for i, w in enumerate(weights):
        h = h @ round_to(w, precision)
        if i < len(weights) - 1:
            h = round_to(torch.relu(h), precision)
    return h


def sh4(d01: torch.Tensor) -> torch.Tensor:
    """Directions mapped to [0,1]^3 -> the 16 SH basis values of degree 4
    (tcnn's polynomial order)."""
    d = d01 * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2), 0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2), 1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2),
    ], dim=-1)


def density_act(raw: torch.Tensor) -> torch.Tensor:
    return torch.exp(raw.clamp(-15.0, 15.0))


def rgb_act(raw: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(raw)


# --- the bake ------------------------------------------------------------------


def occupied(bitfield: torch.Tensor, pos: torch.Tensor, casc: int) -> torch.Tensor:
    """bool (K, G, G, G) grid, pos (N, 3) -> occupied at cascade `casc`
    (outside the cascade's cube: not occupied)."""
    g = bitfield.shape[1]
    rel = (pos - 0.5) / float(2.0 ** casc) + 0.5
    cell = torch.floor(rel * g).to(torch.int64)
    inb = ((cell >= 0) & (cell < g)).all(dim=-1)
    cc = cell.clamp(0, g - 1)
    return bitfield[casc][cc[:, 0], cc[:, 1], cc[:, 2]] & inb


def probe_ids(n_vertices: int, subset: int = SCALE_PROBES) -> np.ndarray:
    """The evenly spaced vertices probed for the row scale: i * (n-1)/(s-1)
    in f32 for i < s-1, then n-1, truncated to integers."""
    div = subset - 1
    out = np.arange(div, dtype=np.float32) * (np.float32(n_vertices - 1) / np.float32(div))
    out = np.concatenate([out, np.asarray([n_vertices - 1], np.float32)])
    return np.unique(out.astype(np.int32))


def bake(encode, density_w, bitfield: torch.Tensor, resolution: int, aabb_scale: float,
         precision: str = "bf16"):
    """The nearest-mode bake -> (rows int16 (K*(R+1)^3, 16), scale (K, 16)).
    `encode(unit_pos)` is the position encoding; culled rows are all
    -32768."""
    R = resolution
    Rv = R + 1
    nv = Rv ** 3
    dev = bitfield.device
    K = bitfield.shape[0]
    dil = F.max_pool3d(bitfield.float()[:, None], 3, stride=1, padding=1)[:, 0] > 0
    amin = 0.5 - 0.5 * aabb_scale

    def feats(ids, casc):
        ext = float(2.0 ** casc)
        lo = 0.5 - 0.5 * ext
        i, j, k = ids // (Rv * Rv), (ids // Rv) % Rv, ids % Rv
        pos = lo + torch.stack([i, j, k], dim=-1).float() / R * ext
        unit = ((pos - amin) / aabb_scale).clamp(0.0, 1.0)
        return mlp(density_w, encode(unit), precision), occupied(dil, pos, casc)

    probes = torch.as_tensor(probe_ids(nv), dtype=torch.int64, device=dev)
    scales = []
    for casc in range(K):
        mx = torch.zeros(density_w[-1].shape[1], device=dev)
        for s in range(0, probes.shape[0], CHUNK):
            f, occ = feats(probes[s:s + CHUNK], casc)
            mx = torch.maximum(mx, torch.where(occ[:, None], f.abs(), 0.0).amax(dim=0))
        scales.append(torch.clamp(mx, min=1e-6) / 32767.0)
    scale = torch.stack(scales)
    rows = torch.empty((K * nv, density_w[-1].shape[1]), dtype=torch.int16, device=dev)
    for casc in range(K):
        for s in range(0, nv, CHUNK):
            ids = torch.arange(s, min(s + CHUNK, nv), device=dev)
            f, occ = feats(ids, casc)
            q = torch.round(f / scale[casc]).clamp(-32767, 32767).to(torch.int16)
            rows[casc * nv + s:casc * nv + s + ids.shape[0]] = torch.where(
                occ[:, None], q, torch.tensor(-32768, dtype=torch.int16, device=dev))
    return rows, scale
