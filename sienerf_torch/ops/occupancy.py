"""Multi-cascade occupancy grid (port of the JAX package's
ops/occupancy.py, with the bit packing of its ops/bits.py): lookups for the
march, and the trainer's update.  Cascade m covers the cube of side 2^m
centred at (0.5, 0.5, 0.5); each cascade is a G^3 grid.

The update keeps per cell an EMA of the optical thickness (activated
density * MIN_CONE_STEPSIZE, decay 0.95): a dense refresh of every cell,
or G^3/4 random cells a cascade, folded in by a max; then the threshold
min(mean, NERF_MIN_OPTICAL_THICKNESS), the max-pool of each cascade into
the centre of the next coarser one, and -1 for cells no training camera
sees.  The random cells and positions are drawn apart from the update
(`draw_density_update`), so that a caller can hand in another package's
draws.

The march loops probe a packed form of the grid, 32 cells to a word
(ops/bits.py: int32 words with the JAX package's uint32 bits).

`bake_fine_bitfield` bakes the render-only fine grid: the trained field's
density at the centres of the fine voxels of every occupied coarse cell,
at `factor` times the training grid's resolution."""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from sienerf_torch.common import MIN_CONE_STEPSIZE, NERF_GRIDSIZE, NERF_MIN_OPTICAL_THICKNESS
from sienerf_torch.ops.bits import lookup_bits, pack_bits


def n_cascades_for_aabb_scale(aabb_scale: float) -> int:
    return 1 + max(0, int(math.ceil(math.log2(max(aabb_scale, 1.0)))))


@dataclass(frozen=True)
class OccupancyConfig:
    n_cascades: int = 1
    decay: float = 0.95
    grid_size: int = NERF_GRIDSIZE


def init_occupancy_state(config: OccupancyConfig, device=None) -> dict:
    """density (C, G, G, G) f32 (< 0 where no camera sees the cell),
    bitfield bool, mean_density a 0-d tensor, n_updates a Python int."""
    g, c = config.grid_size, config.n_cascades
    return {
        "density": torch.zeros((c, g, g, g), dtype=torch.float32, device=device),
        "bitfield": torch.zeros((c, g, g, g), dtype=torch.bool, device=device),
        "mean_density": torch.zeros((), dtype=torch.float32, device=device),
        "n_updates": 0,
    }


def cell_center(idx_xyz: torch.Tensor, mip, grid_size: int = NERF_GRIDSIZE) -> torch.Tensor:
    """Cell index (..., 3) at cascade `mip` -> world position of its centre."""
    scale = torch.exp2(torch.as_tensor(mip, dtype=torch.float32,
                                       device=idx_xyz.device))[..., None]
    return ((idx_xyz.float() + 0.5) / grid_size - 0.5) * scale + 0.5


def mark_untrained_cells(config: OccupancyConfig, xforms: np.ndarray,
                         focal_lengths: np.ndarray, resolutions: np.ndarray) -> np.ndarray:
    """(C, G, G, G) bool numpy mask of the cells at least one training
    camera sees: the cell centre, inflated by half a diagonal, projects
    in front of the camera and inside its image (the JAX package's numpy
    test, camera by camera, stopping once every cell is seen; the cameras
    run in groups on a thread pool, since numpy releases the interpreter
    lock in its loops, and their masks are ORed, so the result does not
    depend on the order)."""
    g = config.grid_size
    idx = np.stack(np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing="ij"),
                   axis=-1)
    masks = []
    xforms = np.asarray(xforms, np.float32)
    R = xforms[:, :3, :3]  # columns are the camera axes
    t = xforms[:, :3, 3]
    for m in range(config.n_cascades):
        centers = ((idx + 0.5) / g - 0.5) * (2.0 ** m) + 0.5
        margin = 0.5 * math.sqrt(3.0) * (2.0 ** m) / g  # half a cell's diagonal
        pts = centers.reshape(-1, 3)

        def seen_by(ci, pts=pts, margin=margin):
            # (pts - t) @ R written out: the same float64 products and sums
            # as numpy's matmul of these shapes, in a fifth of its time
            rel, Rc = pts - t[ci], R[ci].astype(np.float64)
            cam = np.stack([rel[:, 0] * Rc[0, j] + rel[:, 1] * Rc[1, j] + rel[:, 2] * Rc[2, j]
                            for j in range(3)], axis=-1)
            z = cam[:, 2]
            fx, fy = focal_lengths[ci]
            w, h = resolutions[ci] if resolutions.ndim > 1 else resolutions
            with np.errstate(divide="ignore", invalid="ignore"):
                x = cam[:, 0] / np.maximum(z, 1e-9)
                y = cam[:, 1] / np.maximum(z, 1e-9)
            return ((z + margin > 0.0)
                    & (np.abs(x) * fx <= 0.5 * w + margin * fx / np.maximum(z, 1e-9) + 1)
                    & (np.abs(y) * fy <= 0.5 * h + margin * fy / np.maximum(z, 1e-9) + 1))

        visible = np.zeros(pts.shape[0], bool)
        n_threads = min(8, os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=n_threads) as ex:
            for c0 in range(0, xforms.shape[0], n_threads):
                for vis in ex.map(seen_by, range(c0, min(c0 + n_threads, xforms.shape[0]))):
                    visible |= vis
                if visible.all():
                    break
        masks.append(visible.reshape(g, g, g))
    return np.stack(masks)


def _eval_chunked(fn, x: torch.Tensor, chunk: int = 1 << 18) -> torch.Tensor:
    """fn over x (M, 3) in chunks of `chunk` rows -> (M,)."""
    return torch.cat([fn(x[s:s + chunk]) for s in range(0, x.shape[0], chunk)])


def _sample_cell_positions(u: torch.Tensor, cascade: int, cell_idx: torch.Tensor,
                           grid_size: int) -> torch.Tensor:
    """World position inside each cell (M, 3) of `cascade` at the offsets
    u (M, 3) in [0, 1)."""
    scale = 2.0 ** cascade
    return ((cell_idx.float() + u) / grid_size - 0.5) * scale + 0.5


def _all_cells(g: int, device) -> torch.Tensor:
    ax = torch.arange(g, device=device)
    return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3)


def draw_density_update(config: OccupancyConfig, dense: bool, generator: torch.Generator,
                        device=None, n_samples_per_cascade: int = NERF_GRIDSIZE ** 3 // 4):
    """The random part of one update: per cascade, the cells (None for a
    dense refresh, which takes every cell in order; else
    `n_samples_per_cascade` flat cell ids) and a uniform offset (M, 3) in
    each."""
    g3 = config.grid_size ** 3
    out = []
    for _ in range(config.n_cascades):
        cells = None
        if not dense:
            cells = torch.randint(0, g3, (n_samples_per_cascade,), generator=generator,
                                  device=device)
        n = g3 if dense else n_samples_per_cascade
        u = torch.rand((n, 3), generator=generator, device=device)
        out.append({"cells": cells, "u": u})
    return out


@torch.no_grad()
def update_density_grid(config: OccupancyConfig, state: dict, density_fn, draws,
                        aabb_min: torch.Tensor, aabb_diag: torch.Tensor,
                        visible_mask: torch.Tensor | None = None) -> dict:
    """One occupancy update from `draws` (draw_density_update; dense when
    its cells are None).  density_fn: (M, 3) unit-box positions ->
    activated density (M,).  Returns the new state."""
    g = config.grid_size
    density = state["density"]
    dense = draws[0]["cells"] is None
    if dense:
        idx = _all_cells(g, density.device)
        new_vals = []
        for m, dr in enumerate(draws):
            pos = _sample_cell_positions(dr["u"], m, idx, g)
            d = _eval_chunked(density_fn, (pos - aabb_min) / aabb_diag) * MIN_CONE_STEPSIZE
            new_vals.append(d.reshape(g, g, g))
        density = torch.maximum(density * config.decay, torch.stack(new_vals))
    else:
        density = density * config.decay
        for m, dr in enumerate(draws):
            flat = dr["cells"].to(torch.int64)
            idx3 = torch.stack([flat // (g * g), (flat // g) % g, flat % g], dim=-1)
            pos = _sample_cell_positions(dr["u"], m, idx3, g)
            d = _eval_chunked(density_fn, (pos - aabb_min) / aabb_diag) * MIN_CONE_STEPSIZE
            dm = density[m].reshape(-1).scatter_reduce(0, flat, d, reduce="amax")
            density[m] = dm.reshape(g, g, g)
    density, bitfield, mean_density = density_to_bitfield(density, visible_mask)
    return {"density": density, "bitfield": bitfield, "mean_density": mean_density,
            "n_updates": int(state["n_updates"]) + 1}


def density_to_bitfield(density: torch.Tensor, visible_mask: torch.Tensor | None = None):
    """(C, G, G, G) density -> (density with -1 where no camera sees the
    cell, bitfield, mean): the threshold min(mean of cascade 0,
    NERF_MIN_OPTICAL_THICKNESS) and the max-pool of each cascade's cells
    (2x2x2) into the centre half of the next coarser one."""
    c, g = density.shape[0], density.shape[1]
    if visible_mask is not None:
        density = torch.where(visible_mask, density, -1.0)
    mean_density = torch.clamp(density[0], min=0.0).mean()
    thresh = torch.clamp(mean_density, max=NERF_MIN_OPTICAL_THICKNESS)
    bitfield = density > thresh
    h, q = g // 2, g // 4
    for m in range(c - 1):
        pooled = bitfield[m].reshape(h, 2, h, 2, h, 2).any(dim=5).any(dim=3).any(dim=1)
        bitfield[m + 1, q:q + h, q:q + h, q:q + h] |= pooled
    return density, bitfield, mean_density


def pos_to_cell(pos: torch.Tensor, mip: torch.Tensor, grid_size: int) -> torch.Tensor:
    """World position (..., 3) -> integer cell coords at cascade `mip`
    (unclamped)."""
    scale = torch.exp2(mip.float())[..., None]
    rel = (pos - 0.5) / scale + 0.5
    return torch.floor(rel * grid_size).to(torch.int64)


def occupancy_lookup(bitfield: torch.Tensor, pos: torch.Tensor,
                     mip: torch.Tensor) -> torch.Tensor:
    """bitfield (C, G, G, G) bool; pos (..., 3); mip (...,) -> occupied
    (...,) bool.  Positions outside the cascade's grid are unoccupied."""
    g = bitfield.shape[1]
    cell = pos_to_cell(pos, mip, g)
    inb = ((cell >= 0) & (cell < g)).all(dim=-1)
    cc = cell.clamp(0, g - 1)
    idx = mip.to(torch.int64) * (g * g * g) + (cc[..., 0] * g + cc[..., 1]) * g + cc[..., 2]
    return bitfield.reshape(-1)[idx] & inb


def mip_from_pos(pos: torch.Tensor, n_cascades: int) -> torch.Tensor:
    """Smallest cascade whose box contains pos (..., 3) -> (...,) int64."""
    d = (pos - 0.5).abs().amax(dim=-1)
    exponent = torch.ceil(torch.log2(torch.clamp(2.0 * d, min=1e-10)))
    return exponent.clamp(0, n_cascades - 1).to(torch.int64)


def mip_from_dt(dt: torch.Tensor, n_cascades: int, grid_size: int) -> torch.Tensor:
    """Coarsest cascade whose voxels are at least dt wide -> int64."""
    exponent = torch.ceil(torch.log2(torch.clamp(dt * grid_size, min=1e-10)))
    return exponent.clamp(0, n_cascades - 1).to(torch.int64)


def pack_occupancy(bitfield: torch.Tensor) -> torch.Tensor:
    """(C, G, G, G) bool -> (ceil(C*G^3 / 128), 4) int32 probe table: the
    JAX package's row-packed uint32 words, bit for bit (ops/bits.py)."""
    return pack_bits(bitfield.reshape(-1))


def occupancy_lookup_packed(words: torch.Tensor, grid_size: int, pos: torch.Tensor,
                            mip: torch.Tensor) -> torch.Tensor:
    """occupancy_lookup on the pack_occupancy words (identical results)."""
    g = grid_size
    cell = pos_to_cell(pos, mip, g)
    inb = ((cell >= 0) & (cell < g)).all(dim=-1)
    cc = cell.clamp(0, g - 1)
    idx = mip.to(torch.int64) * (g * g * g) + (cc[..., 0] * g + cc[..., 1]) * g + cc[..., 2]
    return lookup_bits(words, idx) & inb


def occupied_bbox(bitfield: torch.Tensor):
    """Tight world-space box of all occupied cells across cascades ->
    (lo (3,), hi (3,)) tensors on the bitfield's device; lo > hi when the
    grid is empty.  Clamping ray entry and exit to it removes most of the
    empty lead-in of a frame's rays."""
    C, G = bitfield.shape[0], bitfield.shape[1]
    idx = torch.arange(G, dtype=torch.float32, device=bitfield.device)
    los, his = [], []
    for c in range(C):
        span = float(2 ** c)
        cell = span / G
        lo_c, hi_c = [], []
        for ax in range(3):
            line = bitfield[c].any(dim=tuple(a for a in range(3) if a != ax))
            first = torch.where(line, idx, float(G)).amin()
            last = torch.where(line, idx, -1.0).amax()
            lo_c.append((0.5 - span / 2) + first * cell)
            hi_c.append((0.5 - span / 2) + (last + 1.0) * cell)
        los.append(torch.stack(lo_c))
        his.append(torch.stack(hi_c))
    return torch.stack(los).amin(dim=0), torch.stack(his).amax(dim=0)


def ray_box_times(o: torch.Tensor, d: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor):
    """Slab test: entry and exit t of rays o + t*d against the box [lo, hi]."""
    safe = torch.where(d.abs() < 1e-12, 1e-12, d)
    ta = (lo[None, :] - o) / safe
    tb = (hi[None, :] - o) / safe
    return torch.minimum(ta, tb).amax(dim=-1), torch.maximum(ta, tb).amin(dim=-1)


@torch.no_grad()
def bake_fine_bitfield(density_fn, coarse_bitfield: torch.Tensor, mean_density: float,
                       factor: int = 4, dilate: bool = True,
                       chunk: int = 1 << 20) -> torch.Tensor:
    """The render-only occupancy grid at `factor` x the training grid:
    `density_fn(pos (M, 3)) -> (M,)` activated density, evaluated at the
    centre of every fine voxel of each occupied coarse cell, `chunk` points
    at a time on the coarse grid's device, and kept above the training
    grid's threshold min(mean_density, NERF_MIN_OPTICAL_THICKNESS) in
    density units (the grid stores optical thickness, density *
    MIN_CONE_STEPSIZE).  `dilate` ORs each voxel with its 26 neighbours (a
    separable 3^3 max as rolls, whose wrap-around only adds voxels) and
    keeps the result inside the occupied coarse cells.  -> (C, G*factor,
    G*factor, G*factor) bool.  The JAX package's bake_fine_bitfield, done
    on the device."""
    coarse = coarse_bitfield.bool()
    dev = coarse.device
    C, G = coarse.shape[0], coarse.shape[1]
    Gf = G * factor
    thresh_raw = float(min(float(mean_density), NERF_MIN_OPTICAL_THICKNESS)) / MIN_CONE_STEPSIZE
    ax = torch.arange(factor, device=dev)
    offs = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1).reshape(-1, 3)
    fine = torch.zeros((C, Gf, Gf, Gf), dtype=torch.bool, device=dev)
    for c in range(C):
        idx = torch.nonzero(coarse[c])  # (M, 3), row-major as np.argwhere
        if idx.shape[0] == 0:
            continue
        fine_idx = (idx[:, None, :] * factor + offs[None]).reshape(-1, 3)
        centers = ((fine_idx.float() + 0.5) / Gf - 0.5) * (2.0 ** c) + 0.5
        occ = torch.cat([density_fn(centers[s:s + chunk]) > thresh_raw
                         for s in range(0, centers.shape[0], chunk)])
        fine[c, fine_idx[:, 0], fine_idx[:, 1], fine_idx[:, 2]] = occ
        del centers, fine_idx
    if dilate:
        for c in range(C):
            f = fine[c]
            for a in range(3):
                f = f | torch.roll(f, 1, dims=a) | torch.roll(f, -1, dims=a)
            up = coarse[c].repeat_interleave(factor, 0).repeat_interleave(factor, 1) \
                .repeat_interleave(factor, 2)
            fine[c] = f & up
    return fine
