"""Occupancy-grid lookups (port of the render subset of
the JAX package's ops/occupancy.py, with the bit packing of its ops/bits.py).
Cascade m covers the cube of side 2^m centred at (0.5, 0.5, 0.5); each
cascade is a G^3 bool grid.

The march loops probe a packed form of the grid, 32 cells to a word.  The
JAX package holds the words as uint32; torch's uint32 arithmetic is
incomplete, so here they are int32 with the same bits (bit i of word w is
flat cell w*32 + i), and a probe shifts and masks."""

from __future__ import annotations

import math

import torch


def n_cascades_for_aabb_scale(aabb_scale: float) -> int:
    return 1 + max(0, int(math.ceil(math.log2(max(aabb_scale, 1.0)))))


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
    JAX package's row-packed uint32 words, bit for bit."""
    flat = bitfield.reshape(-1)
    pad = (-flat.shape[0]) % 128
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.ones((), dtype=torch.int64, device=flat.device) << torch.arange(
        32, dtype=torch.int64, device=flat.device)
    words = (flat.reshape(-1, 4, 32).to(torch.int64) * weights).sum(dim=2)
    # values >= 2^31 wrap to the negative int32 with the same bits
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def lookup_bits(words: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Packed-bit test: flat bit ids (int64) -> bool."""
    w = words.reshape(-1)[flat >> 5]
    return ((w >> (flat & 31).to(torch.int32)) & 1).bool()


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
