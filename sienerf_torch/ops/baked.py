"""Baked feature grid: the render-side field cache (port of the JAX
package's ops/baked.py).

The density branch's 16-wide raw output is baked onto one (R+1)^3 vertex
lattice per occupancy cascade (cascade m is the cube of side 2^m centred
at 0.5), concatenated into one row table, so that a sample costs one row
gather and the colour MLP.  Rows are kept in their own integer type:
`int16 (N, F)` at 16 bits and `int8 (N, F)` at 8 bits, where the JAX
package bitcasts pairs or quads into int32 lanes for the TPU's gather.
The most negative code in channel 0 (-32768 / -128) is the sentinel of a
culled vertex; the whole row carries it, and it decodes to raw density
-100.

Layouts: vertex rows ("nearest" sampling, one row a sample), cell rows
("trilinear": the 8 corner rows of a cell in one row of 8*F values, corner
c = (dx << 2) | (dy << 1) | dz) and brick rows (the 2x2x4 vertices of a
brick in one row of 16*F values, offset ox*8 + oy*4 + oz), which a ray's
consecutive survivors share.

Sidecars for the candidate cull and the empty-space advance: packed live
bits at full, half (two packings) and quarter resolution, the trilinear
cover, and a byte-packed Chebyshev distance field over the training
occupancy grid (ops/bits.py holds the packing).

The feature gathers go through the hand-written kernels on CUDA tensors:
G2 (`ops/gather.py::gather_small`) for vertex and cell rows and 256-byte
bricks, G1 (`gather_rows`) for 512-byte bricks; CPU tensors take the
plain index_select.  `impl="plain"` takes the plain version on the card,
so that a caller can hold the kernels to it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sienerf_torch.ops.bits import (
    brick_grid_dims,
    brick_probe_ids,
    lookup_bits,
    pack_bits,
    pack_bits_brick,
    pack_bytes,
    run_slots,
)
from sienerf_torch.ops.exact import route_select
from sienerf_torch.ops.gather import (
    ROW_LANES,
    gather_rows,
    gather_rows_plain,
    gather_small,
    gather_small_plain,
)
from sienerf_torch.ops.occupancy import mip_from_pos

N_BAKED_FEATURES = 16
_SENTINEL_RAW = -100.0  # pre-activation density of culled and out-of-grid samples
_CORNER_BITS = [((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8)]
FINE_BRICK = (2, 2, 4)  # vertices of a feature brick: 16 rows of F values


def cascade_extent(mip) -> torch.Tensor:
    """Side length of cascade `mip`'s cube (centred at 0.5)."""
    return torch.exp2(torch.as_tensor(mip, dtype=torch.float32))


def quantize_rows(feats: torch.Tensor, scale: torch.Tensor, keep: torch.Tensor,
                  bits: int = 16) -> torch.Tensor:
    """(N, F) f32 + (F,) scale + (N,) keep mask -> (N, F) int16 (bits=16)
    or int8 (bits=8) rows; dropped rows are all sentinel."""
    lim, dtype = (127, torch.int8) if bits == 8 else (32767, torch.int16)
    q = torch.round(feats / scale).clamp(-lim, lim).to(dtype)
    return torch.where(keep[:, None], q, torch.tensor(-lim - 1, dtype=dtype, device=q.device))


def row_bits(rows: torch.Tensor) -> int:
    return 8 if rows.dtype == torch.int8 else 16


def _decode_rows(rows: torch.Tensor, scale: torch.Tensor):
    """(..., F) int rows + broadcastable scale -> ((..., F) f32, sentinel)."""
    sent = rows[..., 0] == (-128 if rows.dtype == torch.int8 else -32768)
    return rows.float() * scale, sent


def _apply_sentinel(feats: torch.Tensor, sent: torch.Tensor) -> torch.Tensor:
    f = torch.where(sent[..., None], 0.0, feats)
    return torch.cat([torch.where(sent, _SENTINEL_RAW, f[..., 0])[..., None], f[..., 1:]],
                     dim=-1)


def _cascade_coords(pos: torch.Tensor, n_cascades: int):
    """World positions -> (cascade, position in the cascade's unit cube,
    out of the outermost cube)."""
    m = mip_from_pos(pos, n_cascades)
    u = (pos - 0.5) / cascade_extent(m).to(pos.device)[..., None] + 0.5
    oob = ((u < 0.0) | (u >= 1.0)).any(dim=-1)
    return m, u, oob


def nearest_vertex_coords(resolution: int, n_cascades: int, pos: torch.Tensor):
    """World positions -> (integer vertex coords (..., 3), oob mask,
    cascade).  The feature lookup and the candidate culls share it, so they
    agree on which vertex a sample reads."""
    m, u, oob = _cascade_coords(pos, n_cascades)
    k3 = torch.round(u * resolution).to(torch.int64).clamp(0, resolution)
    return k3, oob, m


def nearest_vertex_ids(resolution: int, n_cascades: int, pos: torch.Tensor):
    """World positions -> (flat nearest-vertex id, oob mask, cascade)."""
    Rv = resolution + 1
    k3, oob, m = nearest_vertex_coords(resolution, n_cascades, pos)
    flat = m * (Rv * Rv * Rv) + (k3[..., 0] * Rv + k3[..., 1]) * Rv + k3[..., 2]
    return flat, oob, m


def _max_pool(x: torch.Tensor, kernel: int, stride: int, pad: int) -> torch.Tensor:
    """Max-pool of a (K, X, Y, Z) lattice with the same window on each axis
    (padding never wins), one axis at a time: a separable max equals the
    3-D window's, and each axis is one reduction over an unfolded view
    (several times faster on the CPU than max_pool3d, the same values)."""
    v = x.to(torch.float32)
    if pad:
        v = F.pad(v, (pad,) * 6, value=float("-inf"))
    for axis in (1, 2, 3):
        v = v.unfold(axis, kernel, stride).amax(-1)
    return v


def _lattice(live_flat: torch.Tensor, resolution: int, n_cascades: int) -> torch.Tensor:
    Rv = resolution + 1
    return live_flat.reshape(n_cascades, Rv, Rv, Rv)


def _coarse_live_pool(live_flat: torch.Tensor, resolution: int, n_cascades: int):
    """(K*(R+1)^3,) live bools -> (K*(R/2+1)^3,) conservative half-res
    cover: a sample's nearest half-res vertex c covers the fine vertices
    [2c-1, 2c+1]^3, a 3^3-OR with stride 2."""
    assert resolution % 2 == 0
    return _max_pool(_lattice(live_flat, resolution, n_cascades), 3, 2, 1).reshape(-1) > 0


def coarse_live_bits(live_flat: torch.Tensor, resolution: int, n_cascades: int):
    """The half-resolution cull sidecar, packed bits over (K, R/2+1)^3:
    every candidate the full-resolution cull keeps is kept here."""
    return pack_bits(_coarse_live_pool(live_flat, resolution, n_cascades))


def coarse_live_bits_brick(live_flat: torch.Tensor, resolution: int, n_cascades: int):
    """coarse_live_bits in 4x4x8-brick packing (lookup_bits_brick)."""
    R2v = resolution // 2 + 1
    return pack_bits_brick(_coarse_live_pool(live_flat, resolution, n_cascades),
                           (n_cascades, R2v, R2v, R2v))


def trilinear_live_bits(live_flat: torch.Tensor, resolution: int, n_cascades: int):
    """The half-resolution cull sidecar of trilinear sampling: a sample's 8
    cell corners lie in [2c-2, 2c+2]^3 of its nearest half-res vertex c, a
    5^3-OR with stride 2."""
    assert resolution % 2 == 0
    pooled = _max_pool(_lattice(live_flat, resolution, n_cascades), 5, 2, 2)
    return pack_bits(pooled.reshape(-1) > 0)


def scout_live_bits(live_flat: torch.Tensor, resolution: int, n_cascades: int):
    """The quarter-resolution dilated scout sidecar, packed bits over
    (K, R/4)^3 cells: cell c is live when a position in it or in one of
    its 26 neighbours reads a live fine vertex, the window [4c-4, 4c+8], a
    13^3-OR with stride 4."""
    assert resolution % 4 == 0
    pooled = _max_pool(_lattice(live_flat, resolution, n_cascades), 13, 4, 4)
    return pack_bits(pooled.reshape(-1) > 0)


def dist_live_cells(live_flat: torch.Tensor, resolution: int, n_cascades: int,
                    max_dist: int = 15) -> torch.Tensor:
    """Quarter-resolution Chebyshev distance to the live vertices: cell c is
    blocking when a position in it reads a live vertex ([4c, 4c+4], a 5-tap
    max-pool with stride 4); byte-packed distances clamped to max_dist
    (_chamfer_pack)."""
    assert resolution % 4 == 0
    pooled = _max_pool(_lattice(live_flat, resolution, n_cascades), 5, 4, 0)
    return _chamfer_pack(pooled > 0, max_dist)


def _chamfer_pack(blocking: torch.Tensor, max_dist: int) -> torch.Tensor:
    """(K, G, G, G) bool blocking cells -> byte-packed Chebyshev distances.
    Each cascade first takes in the previous one's blocking set, 2x2x2
    max-pooled into its central half (a segment that crosses into the inner
    cube stays covered); then max_dist-1 rounds of a separable 3-tap
    min-pool give the exact distances up to the clamp."""
    K, G = blocking.shape[0], blocking.shape[1]
    blk = [blocking[k].clone() for k in range(K)]
    s, w = G // 4, G // 2
    for m in range(1, K):
        sub = F.max_pool3d(blk[m - 1].to(torch.float32)[None, None], 2, 2)[0, 0] > 0
        blk[m][s:s + w, s:s + w, s:s + w] |= sub
    D = torch.where(torch.stack(blk), 0.0, float(max_dist))
    for _ in range(max_dist - 1):
        D = torch.minimum(D, -_max_pool(-D, 3, 1, 1) + 1.0)
    return pack_bytes(D.reshape(-1).to(torch.int64))


def dist_occupancy_cells(bitfield: torch.Tensor, max_dist: int = 31) -> torch.Tensor:
    """The Chebyshev distance to the occupied cells of the training
    occupancy grid (K, G, G, G), byte-packed: a jump of D-1 cells crosses
    no cell the serial DDA would stop at."""
    return _chamfer_pack(bitfield, max_dist)


def cull_candidates(words: torch.Tensor, resolution: int, n_cascades: int,
                    pos: torch.Tensor) -> torch.Tensor:
    """True where the nearest baked vertex carries live density."""
    flat, oob, _ = nearest_vertex_ids(resolution, n_cascades, pos)
    return lookup_bits(words, flat) & ~oob


def merge_same_vertex_runs(flat: torch.Tensor, keep: torch.Tensor, dts: torch.Tensor,
                           max_run: int = 12):
    """Collapse consecutive kept candidates that read the same nearest
    vertex into the run's head, with the run's dts summed (exact for
    nearest sampling: constant density and colour over a run composite
    through the total dt).  -> (head mask (A, P), merged dts (A, P)); runs
    longer than max_run split."""
    eq = torch.zeros_like(keep)
    eq[:, 1:] = (flat[:, 1:] == flat[:, :-1]) & keep[:, 1:] & keep[:, :-1]
    head = keep & ~eq

    def shl(x, s):  # x[:, j+s] at column j, zero-padded
        return F.pad(x[:, s:], (0, s))

    dt_acc = dts
    prod = None
    for s in range(1, min(max_run, dts.shape[1])):
        prod = shl(eq, s) if prod is None else prod & shl(eq, s)
        dt_acc = dt_acc + torch.where(prod, shl(dts, s), 0.0)
    return head, dt_acc


def compact_candidates(keep: torch.Tensor, n_keep: int, *arrays):
    """Stable-compact per-ray candidates: (A, P) keep mask + per-candidate
    arrays -> (kept (A, n_keep), the first n_keep kept columns of each
    array).  Slots past a ray's kept count hold its dropped candidates in
    order, as the JAX package's sort leaves them."""
    A, P = keep.shape
    j = torch.arange(P, device=keep.device)[None, :]
    key = torch.where(keep, j, j + P)
    key_s, order = torch.sort(key, dim=1)  # keys are unique: any sort is stable
    order = order[:, :n_keep]
    return (key_s[:, :n_keep] < P,) + tuple(torch.gather(a, 1, order) for a in arrays)


def compact_candidates_onehot(keep: torch.Tensor, n_keep: int, *arrays):
    """compact_candidates' contract with the destination slot of each kept
    candidate from a prefix count, scattered; slots past a ray's kept count
    hold 0 in every array."""
    A, P = keep.shape
    dest = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    tgt = torch.where(keep & (dest < n_keep), dest, n_keep)
    outs = []
    for a in arrays:
        o = torch.zeros((A, n_keep + 1), dtype=a.dtype, device=a.device)
        outs.append(o.scatter_(1, tgt, a)[:, :n_keep])
    n_sel = dest[:, -1] + 1
    kept = torch.arange(n_keep, device=keep.device)[None, :] < n_sel[:, None]
    return (kept,) + tuple(outs)


def _row_ids(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Row ids (any shape) -> contiguous int32 (N,) in [0, n_rows): the
    kernels assert on an index out of range, and the ids of dead and
    out-of-grid samples are only masked later."""
    return ids.reshape(-1).clamp(0, n_rows - 1).to(torch.int32).contiguous()


def gather_table_rows(table: torch.Tensor, ids: torch.Tensor,
                      impl: str = "kernel") -> torch.Tensor:
    """Rows of a row table at `ids` -> (N, C): G2 on CUDA tensors (rows of
    16, 32, 128 or 256 bytes), G1 for 512-byte rows; CPU tensors, or
    impl="plain", take the plain version."""
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    idx = _row_ids(ids, table.shape[0])
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == ROW_LANES * 4:
        t32 = table.view(torch.int32)
        fn = gather_rows if impl == "kernel" else gather_rows_plain
        return fn(t32, idx)[:, 0].view(table.dtype)
    fn = gather_small if impl == "kernel" else gather_small_plain
    return fn(table, idx)


def baked_features(rows: torch.Tensor, scale: torch.Tensor, resolution: int,
                   n_cascades: int, mode: str, pos: torch.Tensor,
                   impl: str = "kernel") -> torch.Tensor:
    """Sample the baked cascades at world positions (N, 3) -> raw features
    (N, F); positions outside the outermost cascade read the sentinel.
    scale is (K, F)."""
    R, K = resolution, n_cascades
    m, u, oob = _cascade_coords(pos, K)
    scale_sel = scale[m]
    if mode == "nearest":
        flat, oob, _ = nearest_vertex_ids(R, K, pos)
        r = gather_table_rows(rows, flat, impl)
        feats, sent = _decode_rows(r, scale_sel)
    elif mode == "trilinear":
        x = u * R
        i = torch.floor(x).to(torch.int64).clamp(0, R - 1)
        frac = (x - i).clamp(0.0, 1.0)
        flat = m * (R * R * R) + (i[..., 0] * R + i[..., 1]) * R + i[..., 2]
        r = gather_table_rows(rows, flat, impl)
        corner, csent = _decode_rows(r.reshape(*flat.shape, 8, rows.shape[-1] // 8),
                                     scale_sel[..., None, :])
        bits = torch.tensor(_CORNER_BITS, dtype=torch.bool, device=pos.device)
        f3 = torch.where(bits, frac[..., None, :], 1.0 - frac[..., None, :])  # (N, 8, 3)
        w = f3[..., 0] * f3[..., 1] * f3[..., 2]
        # sentinel corners weigh 0 and the rest renormalise, so a surface
        # cell beside culled space keeps unbiased values
        w = torch.where(csent, 0.0, w)
        wsum = w.sum(dim=-1, keepdim=True)
        feats = (w[..., None] * corner).sum(dim=-2) / torch.clamp(wsum, min=1e-8)
        sent = wsum[..., 0] <= 0.0
    else:
        raise ValueError(f"unknown baked sampling mode: {mode}")
    return _apply_sentinel(feats, sent | oob)


def _vertex_flat(casc, i, j, k, resolution: int) -> torch.Tensor:
    Rv = resolution + 1
    return casc * (Rv * Rv * Rv) + (i * Rv + j) * Rv + k


def pack_bricks_from_vertices(vrows: torch.Tensor, resolution: int, n_cascades: int = 1,
                              chunk: int = 1 << 19) -> torch.Tensor:
    """(K*(R+1)^3, F) vertex rows -> (K*BX*BY*BZ, 16*F) brick rows: the
    2x2x4 vertices of each brick in brick_probe_ids order (ox*8 + oy*4 +
    oz).  Edge bricks repeat the rim vertices, which no sample reads."""
    R, Rv = resolution, resolution + 1
    bx, by, bz = FINE_BRICK
    BX, BY, BZ = brick_grid_dims((n_cascades, Rv, Rv, Rv), FINE_BRICK)
    n_per = BX * BY * BZ
    total = n_cascades * n_per
    dev = vrows.device
    o = torch.tensor([(ox, oy, oz) for ox in range(bx) for oy in range(by) for oz in range(bz)],
                     device=dev)
    out = torch.empty((total, 16 * vrows.shape[1]), dtype=vrows.dtype, device=dev)
    for s in range(0, total, chunk):
        bids = torch.arange(s, min(s + chunk, total), device=dev)
        casc, r = bids // n_per, bids % n_per
        i = torch.clamp((r // (BY * BZ))[:, None] * bx + o[:, 0], max=R)
        j = torch.clamp(((r // BZ) % BY)[:, None] * by + o[:, 1], max=R)
        k = torch.clamp((r % BZ)[:, None] * bz + o[:, 2], max=R)
        out[s:s + bids.shape[0]] = vrows[_vertex_flat(casc[:, None], i, j, k, R)].reshape(
            bids.shape[0], -1)
    return out


def baked_features_brick(brows: torch.Tensor, scale: torch.Tensor, resolution: int,
                         n_cascades: int, pos: torch.Tensor, n_heads: int,
                         impl: str = "kernel"):
    """Nearest-vertex features through the brick table, each ray's runs of
    survivors in one brick gathered once: (A, E, 3) positions -> (raw
    features (A, E, F) with the sentinel, overflow (A, E)).  A ray reads
    the bricks of its first n_heads runs; later survivors are reported in
    the overflow mask (their features are not to be used)."""
    R, K = resolution, n_cascades
    Rv = R + 1
    k3, oob, m = nearest_vertex_coords(R, K, pos)
    row, off = brick_probe_ids(k3, m, (K, Rv, Rv, Rv), FINE_BRICK)
    A, E = row.shape
    _, slot, ovf, ids = run_slots(row, n_heads)
    n_feat = brows.shape[1] // 16
    bricks = gather_table_rows(brows, ids, impl).reshape(A, n_heads * 16, n_feat)
    q = torch.clamp(slot, max=n_heads - 1) * 16 + off
    r = route_select(q, torch.ones_like(ovf), bricks)  # (A, E, F)
    feats, sent = _decode_rows(r, scale[m])
    return _apply_sentinel(feats, sent | oob), ovf


def pack_cells_from_vertices(vrows: torch.Tensor, resolution: int, n_cascades: int = 1,
                             chunk: int = 1 << 20) -> torch.Tensor:
    """(K*(R+1)^3, F) vertex rows -> (K*R^3, 8*F) cell rows, corner c =
    (dx << 2) | (dy << 1) | dz."""
    R = resolution
    n_cells = R * R * R
    total = n_cascades * n_cells
    dev = vrows.device
    c = torch.tensor(_CORNER_BITS, device=dev)
    out = torch.empty((total, 8 * vrows.shape[1]), dtype=vrows.dtype, device=dev)
    for s in range(0, total, chunk):
        ids = torch.arange(s, min(s + chunk, total), device=dev)
        casc, cid = ids // n_cells, ids % n_cells
        i = (cid // (R * R))[:, None] + c[:, 0]
        j = ((cid // R) % R)[:, None] + c[:, 1]
        k = (cid % R)[:, None] + c[:, 2]
        out[s:s + ids.shape[0]] = vrows[_vertex_flat(casc[:, None], i, j, k, R)].reshape(
            ids.shape[0], -1)
    return out
