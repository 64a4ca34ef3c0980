"""Packed bit and byte tables (port of the JAX package's ops/bits.py): the
occupancy grid and the baked renderer's sidecars are probed inside march
loops, so boolean fields pack 32 to a word and small integer fields 4 to a
word, rows of 4 words (16 bytes).

Words are int32 with the JAX package's uint32 bits (torch's uint32
arithmetic is incomplete): bit i of word w is flat id w*32 + i, byte i of
word w is flat id w*4 + i, and word w lives at [w >> 2, w & 3].  A probe
reads the word and shifts, which gives the JAX row gather's result.

Brick packing (pack_bits_brick) lays a lattice out in 4x4x8 bricks, one
128-bit row each, so that consecutive candidates along a ray share rows;
lookup_bits_brick reads each ray's distinct consecutive rows once, up to a
head budget, and keeps every probe beyond it (a conservative keep).

The JAX package's SIENERF_BITS switch (a word gather in place of the row
gather, bit-equal to it) is a TPU A/B probe and is not ported.
"""

from __future__ import annotations

import torch

from sienerf_torch.ops.exact import route_compact, route_select

BRICK = (4, 4, 8)  # x, y, z vertices per brick = 128 bits = one 16-byte row


def _words_from_int64(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def pack_bits(keep: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (ceil(N/128), 4) int32 rows of the bits."""
    flat = keep.reshape(-1)
    pad = (-flat.shape[0]) % 128
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    weights = torch.ones((), dtype=torch.int64, device=flat.device) << torch.arange(
        32, dtype=torch.int64, device=flat.device)
    return _words_from_int64((flat.reshape(-1, 4, 32).to(torch.int64) * weights).sum(dim=2))


def lookup_bits(words: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Packed-bit test: flat bit ids -> bool."""
    flat = flat.to(torch.int64)
    w = words.reshape(-1)[flat >> 5]
    return ((w >> (flat & 31).to(torch.int32)) & 1).bool()


def brick_grid_dims(dims, brick=BRICK):
    """Lattice (K, X, Y, Z) -> per-cascade brick-grid dims (BX, BY, BZ)."""
    _, X, Y, Z = dims
    bx, by, bz = brick
    return -(-X // bx), -(-Y // by), -(-Z // bz)


def pack_bits_brick(keep: torch.Tensor, dims, brick=BRICK) -> torch.Tensor:
    """(K*X*Y*Z,) bool over a (K, X, Y, Z) lattice -> (K*BX*BY*BZ, 4) int32
    rows, one brick a row.  The bit offset within a brick is
    ox*(by*bz) + oy*bz + oz."""
    K, X, Y, Z = dims
    bx, by, bz = brick
    BX, BY, BZ = brick_grid_dims(dims, brick)
    v = keep.reshape(K, X, Y, Z)
    v = torch.nn.functional.pad(v, (0, BZ * bz - Z, 0, BY * by - Y, 0, BX * bx - X))
    v = v.reshape(K, BX, bx, BY, by, BZ, bz).permute(0, 1, 3, 5, 2, 4, 6)
    return pack_bits(v.reshape(-1))


def brick_probe_ids(k3: torch.Tensor, casc: torch.Tensor, dims, brick=BRICK):
    """Integer vertex coords (..., 3) + cascade (...,) -> (row, off) into the
    brick-packed table."""
    bx, by, bz = brick
    BX, BY, BZ = brick_grid_dims(dims, brick)
    kx, ky, kz = k3[..., 0], k3[..., 1], k3[..., 2]
    row = ((casc * BX + (kx // bx)) * BY + (ky // by)) * BZ + (kz // bz)
    off = (kx % bx) * (by * bz) + (ky % by) * bz + (kz % bz)
    return row, off


def run_slots(row: torch.Tensor, n_heads: int):
    """Runs of equal consecutive rows along the candidate axis of (A, P):
    -> (head (A, P) bool, slot (A, P) the run's index, ovf = slot >=
    n_heads, ids (A, n_heads) the row of each run, 0 where a ray has fewer
    runs)."""
    head = torch.ones_like(row, dtype=torch.bool)
    head[:, 1:] = row[:, 1:] != row[:, :-1]
    slot = torch.cumsum(head.to(torch.int32), dim=1) - 1
    ovf = slot >= n_heads
    ids = route_compact(slot, head & ~ovf, row.to(torch.int32)[..., None], n_heads)[..., 0]
    return head, slot, ovf, ids


def lookup_bits_brick(words: torch.Tensor, row: torch.Tensor, off: torch.Tensor,
                      n_heads: int) -> torch.Tensor:
    """Chain-deduped brick probe: (A, P) per-candidate (row, off) -> (A, P)
    bool.  Each ray reads the rows of its first `n_heads` runs; candidates
    past the budget return True."""
    A, P = row.shape
    _, slot, ovf, ids = run_slots(row, n_heads)
    rows4 = words[ids.to(torch.int64)].reshape(A, n_heads, 4)
    myrow = route_select(slot, ~ovf, rows4)  # (A, P, 4)
    w = torch.gather(myrow, 2, (off >> 5).to(torch.int64)[..., None])[..., 0]
    bit = ((w >> (off & 31).to(torch.int32)) & 1).bool()
    return bit | ovf


def pack_bytes(vals: torch.Tensor) -> torch.Tensor:
    """(N,) integer values in [0, 255] -> (ceil(N/16), 4) int32 rows, 16
    bytes a row."""
    v = vals.reshape(-1).to(torch.int64)
    pad = (-v.shape[0]) % 16
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    shifts = torch.arange(4, dtype=torch.int64, device=v.device) * 8
    return _words_from_int64((v.reshape(-1, 4, 4) << shifts).sum(dim=2))


def lookup_bytes(rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Byte-packed table read: flat ids -> int32 values in [0, 255]."""
    flat = flat.to(torch.int64)
    word = rows.reshape(-1)[flat >> 2]
    return (word >> ((flat & 3) * 8).to(torch.int32)) & 0xFF
