"""The baked gather renderer (port of the JAX package's
engines/nerf_baked.py): bake once, then render frames from the bake.

1. `bake_feature_grid` evaluates the density branch at every vertex of one
   (R+1)^3 lattice per occupancy cascade, quantises the 16 raw features
   per (cascade, field) and packs the row table and its sidecars: live
   bits at full, half and quarter resolution, the distance field of the
   training occupancy grid, brick rows and, for trilinear sampling, cell
   rows (ops/baked.py).  Vertices outside the dilated trained occupancy
   get the sentinel row.
2. `render_frame_baked` streams the frame's pixels through a fixed buffer
   of ray slots, as the live renderer does (engines/nerf.py).  A round
   advances each ray through empty space, lays a closed-form cone-step
   chain of candidates from its position, culls them on a live-bit
   sidecar, merges runs that read one vertex, compacts the survivors to
   `evals` a ray, gathers their feature rows (G2, or G1 for bricks, on the
   card), runs the colour MLP and composites.  A ray with more survivors
   than `evals` rolls its clock back to the first one dropped, so no dense
   sample is skipped.  `render_rays_baked` runs a fixed ray batch, the
   hybrid frame's unit.

The JAX package loops on the device (`lax.while_loop`); here the loop is a
Python loop that asks the device once a round whether a ray is alive, and
counts its rounds.  The gather-strategy knobs (cull, fine, heads, adv)
take their defaults from SIENERF_CULL, SIENERF_FINE, SIENERF_CULL_HEADS,
SIENERF_FINE_HEADS and SIENERF_ADV, as in the JAX package.

A network with extra dims shades every candidate with one row of them
(training view 0's, or the `extra_row` a frame is given).
`render_frame_baked_multichip` splits a frame's rays over the ranks of a
mesh (parallel/mesh.py), each rank running render_rays_baked over its
tiles from its own copy of the bake.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from sienerf_torch.common import (
    MIN_CONE_STEPSIZE,
    NERF_MIN_OPTICAL_THICKNESS,
    NERF_RENDERING_NEAR_DISTANCE,
)
from sienerf_torch.engines.nerf import NerfEngine
from sienerf_torch.models.nerf_network import (
    _encode_pos,
    apply_density_activation,
    apply_rgb_activation,
)
from sienerf_torch.ops.baked import (
    baked_features,
    baked_features_brick,
    cascade_extent,
    coarse_live_bits,
    coarse_live_bits_brick,
    compact_candidates,
    dist_occupancy_cells,
    merge_same_vertex_runs,
    nearest_vertex_coords,
    nearest_vertex_ids,
    pack_bricks_from_vertices,
    pack_cells_from_vertices,
    quantize_rows,
    scout_live_bits,
    trilinear_live_bits,
)
from sienerf_torch.ops.bits import (
    brick_probe_ids,
    lookup_bits,
    lookup_bits_brick,
    lookup_bytes,
    pack_bits,
)
from sienerf_torch.ops.encodings import sh_encode
from sienerf_torch.ops.envmap import background_behind_envmap
from sienerf_torch.ops.mlp import mlp_apply
from sienerf_torch.ops.occupancy import (
    mip_from_pos,
    occupancy_lookup,
    occupied_bbox,
    pack_occupancy,
    ray_box_times,
)
from sienerf_torch.ops.raymarch import advance_to_occupied, composite_chunk, retreat_to_occupied
from sienerf_torch.tracing import PhaseClock
from sienerf_torch.utils.camera import pixel_grid_uv, uv_to_ray

_CHUNK = 1 << 19          # vertices evaluated per step
_SCALE_PROBES = 1 << 18   # the reference's scale-probe count
# a frame's phases (render_frame_baked's stats with sync_phases set)
BAKED_PHASES = ("setup", "init_advance", "advance", "cull", "compact", "gather", "mlp",
                "composite", "flush")


def _f32(x: float) -> float:
    """A Python float rounded to f32, so that an f32 tensor op with it as a
    scalar computes with the f32 value the JAX package's weak-typed
    constant takes."""
    return float(np.float32(x))


def _dilate3(bitfield: torch.Tensor) -> torch.Tensor:
    """3^3 binary dilation per cascade of a (C, G, G, G) bool bitfield."""
    x = bitfield.to(torch.float32)[:, None]
    return F.max_pool3d(x, kernel_size=3, stride=1, padding=1)[:, 0] > 0


def _vertex_positions(ids: torch.Tensor, resolution: int, lo, hi) -> torch.Tensor:
    Rv = resolution + 1
    i = ids // (Rv * Rv)
    j = (ids // Rv) % Rv
    k = ids % Rv
    frac = torch.stack([i, j, k], dim=-1).float() / resolution
    return lo + frac * (hi - lo)


def _scale_probe_ids(n_vertices: int, subset: int) -> np.ndarray:
    """The vertex ids the reference probes for the quantisation scale:
    jnp.linspace(0, n-1, subset) in f32, truncated to int32.  XLA folds
    that constant to iota * ((n-1) / (subset-1)) in f32; the same f32
    arithmetic is repeated here so both packages probe the same set."""
    div = subset - 1
    out = np.arange(div, dtype=np.float32) * (np.float32(n_vertices - 1) / np.float32(div))
    out = np.concatenate([out, np.asarray([n_vertices - 1], np.float32)])
    return np.unique(out.astype(np.int32))


@torch.no_grad()
def bake_feature_grid(engine, params: dict, bitfield: torch.Tensor,
                      resolution: int = 256, mode: str = "nearest",
                      row_bits: int = 16, bricks: bool | None = None):
    """-> (grid, meta), meta = {"resolution", "mode", "n_cascades"}.

    grid: "rows" ((K*(R+1)^3, 16) int16 or int8 vertex rows; for mode
    "trilinear" the (K*R^3, 8*16) cell rows), "scale" (K, 16) f32 (the max
    |raw feature| over _SCALE_PROBES evenly spaced vertices per cascade, as
    the reference probes it), the packed live bits "bits" (full
    resolution), "bits2" and "bits2b" (half, linear and brick packing),
    "bits3" (quarter, dilated), "dist3d" (the byte-packed distance field of
    the training grid), "bits2t" for trilinear bakes, and "brows" (brick
    rows) for nearest bakes when `bricks` is True (None: R <= 256)."""
    if mode not in ("nearest", "trilinear"):
        raise ValueError(f"unknown baked sampling mode: {mode}")
    R = resolution
    Rv = R + 1
    n_vertices = Rv ** 3
    dev = bitfield.device
    dilated = _dilate3(bitfield)
    n_casc = int(bitfield.shape[0])
    amin = torch.as_tensor(engine.aabb.min, device=dev)
    adiag = torch.as_tensor(engine.aabb.diag, device=dev)
    net = engine.net
    live_thresh = 0.1 * NERF_MIN_OPTICAL_THICKNESS

    def vertex_feats(ids, casc):
        ext = cascade_extent(casc).to(dev)
        lo = 0.5 - 0.5 * ext
        pos = _vertex_positions(ids, R, lo, lo + ext)
        unit = ((pos - amin) / adiag).clamp(0.0, 1.0)
        feats = mlp_apply(net.density_mlp, params["density_mlp"],
                          _encode_pos(net, params, unit))
        # culled by the dilated training grid at the vertex's own cascade
        occ = occupancy_lookup(dilated, pos, torch.full_like(ids, casc))
        # a live vertex is optically thick over one minimum step: the cull
        # sidecars skip candidates whose vertex is not
        dens = apply_density_activation(feats[..., 0], net.density_activation)
        live = occ & (dens * MIN_CONE_STEPSIZE > live_thresh)
        return feats, occ, live

    probe = torch.as_tensor(_scale_probe_ids(n_vertices, _SCALE_PROBES), dtype=torch.int64,
                            device=dev)
    lim = 127.0 if row_bits == 8 else 32767.0
    scales = []
    for k in range(n_casc):
        mx = torch.zeros(net.density_mlp.n_output_dims, device=dev)
        for s in range(0, probe.shape[0], _CHUNK):
            feats, occ, _ = vertex_feats(probe[s:s + _CHUNK], k)
            mx = torch.maximum(mx, torch.where(occ[:, None], feats.abs(), 0.0).amax(dim=0))
        scales.append(torch.clamp(mx, min=1e-6) / lim)
    scale = torch.stack(scales)  # (K, F)

    rows = torch.empty((n_casc * n_vertices, net.density_mlp.n_output_dims),
                       dtype=torch.int8 if row_bits == 8 else torch.int16, device=dev)
    live_all = torch.empty((n_casc * n_vertices,), dtype=torch.bool, device=dev)
    for k in range(n_casc):
        for s in range(0, n_vertices, _CHUNK):
            ids = torch.arange(s, min(s + _CHUNK, n_vertices), device=dev)
            feats, occ, live = vertex_feats(ids, k)
            at = slice(k * n_vertices + s, k * n_vertices + s + ids.shape[0])
            rows[at] = quantize_rows(feats, scale[k], occ, row_bits)
            live_all[at] = live
    grid = {
        "scale": scale,
        "bits": pack_bits(live_all),
        "bits2": coarse_live_bits(live_all, R, n_casc),
        "bits2b": coarse_live_bits_brick(live_all, R, n_casc),
        "bits3": scout_live_bits(live_all, R, n_casc),
        # the jump field of the training grid, the set the DDA walks
        "dist3d": dist_occupancy_cells(bitfield),
    }
    if mode == "trilinear":
        grid["bits2t"] = trilinear_live_bits(live_all, R, n_casc)
        grid["rows"] = pack_cells_from_vertices(rows, R, n_casc)
        del rows
    else:
        grid["rows"] = rows
        if bricks is None:
            bricks = R <= 256
        if bricks:
            grid["brows"] = pack_bricks_from_vertices(rows, R, n_casc)
    return grid, {"resolution": R, "mode": mode, "n_cascades": n_casc}


# --- rendering ---------------------------------------------------------------


_NO_CLOCK = PhaseClock(None, torch.device("cpu"))


def _candidate_chain(t0: torch.Tensor, cone_angle: float, n: int, step_scale: float):
    """Cone-step candidate times from per-ray t0 in closed form: (N,) ->
    ts (N, n), dts (N, n), t_end (N,).  The recurrence
    t_{j+1} = t_j + clip(c*t_j, dmin, dmax) is uniform steps of dmin while
    t < dmin/c, then geometric growth by (1 + c); dmax lies beyond any bake
    and is ignored."""
    j = torch.arange(n, dtype=torch.float32, device=t0.device)[None, :]
    dmin = _f32(MIN_CONE_STEPSIZE * step_scale)
    if cone_angle <= 0.0:
        ts = t0[:, None] + j * dmin
        return ts, torch.full_like(ts, dmin), t0 + float(n) * dmin
    c = _f32(cone_angle * step_scale)
    t_star = _f32(MIN_CONE_STEPSIZE / cone_angle)  # uniform -> geometric switch
    log1p_c = torch.log1p(torch.tensor(c, dtype=torch.float32, device=t0.device))
    n_u = torch.ceil(torch.clamp(t_star - t0, min=0.0) / dmin)[:, None]  # (N, 1)
    t_u = t0[:, None] + n_u * dmin  # the first geometric t
    grow = torch.exp(torch.clamp(j - n_u, min=0.0) * log1p_c)
    ts = torch.where(j < n_u, t0[:, None] + j * dmin, t_u * grow)
    dts = torch.clamp(ts * c, min=dmin)
    t_end = torch.where(float(n) < n_u[:, 0], t0 + float(n) * dmin,
                        t_u[:, 0] * torch.exp(torch.clamp(float(n) - n_u[:, 0], min=0.0)
                                              * log1p_c))
    return ts, dts, t_end


def _colors_from_raw(engine, params: dict, raw: torch.Tensor, d: torch.Tensor, shape,
                     valid: torch.Tensor):
    """(A*P, F) raw baked features -> per-candidate (rgb (A, P, 3), density
    (A, P)) through the colour MLP, with the params' render row of extra
    dims (NerfEngine._render_extra; zeros when they have none)."""
    A, P = shape
    net = engine.net
    dens = apply_density_activation(raw[:, 0], net.density_activation)
    dirw = (d / torch.sqrt((d * d).sum(dim=-1, keepdim=True)) + 1.0) * 0.5
    sh = sh_encode(dirw, net.sh_degree)  # (A, sh)
    parts = [sh[:, None, :].expand(A, P, sh.shape[-1]).reshape(A * P, -1)]
    if net.n_extra_dims:
        row = engine._render_extra(params)
        if row is None:
            row = torch.zeros((net.n_extra_dims,), dtype=torch.float32, device=raw.device)
        parts.append(row.expand(A * P, net.n_extra_dims))
    parts.append(raw)
    rgb_raw = mlp_apply(net.rgb_mlp, params["rgb_mlp"], torch.cat(parts, dim=-1))
    rgb = apply_rgb_activation(rgb_raw, net.rgb_activation).reshape(A, P, 3)
    return rgb, torch.where(valid, dens.reshape(A, P), 0.0)


def with_extra_row(params: dict, extra_row) -> dict:
    """The params a frame renders with: with `extra_row` given, its render
    row of extra dims (view 0's by default) is that row."""
    if extra_row is None:
        return params
    row = torch.as_tensor(extra_row, dtype=torch.float32, device=params["rgb_mlp"][0].device)
    return dict(params, extra_dims=row.reshape(1, -1))


def _baked_sample_colors(engine, params, grid, meta, o, d, ts, valid, impl="kernel",
                         clock=_NO_CLOCK):
    """Baked features + the colour MLP at candidates (A, P)."""
    pos = o[:, None, :] + ts[..., None] * d[:, None, :]
    raw = baked_features(grid["rows"], grid["scale"], meta["resolution"], meta["n_cascades"],
                         meta["mode"], pos.reshape(-1, 3), impl)
    clock.phase("gather")
    out = _colors_from_raw(engine, params, raw, d, ts.shape, valid)
    clock.phase("mlp")
    return out


def _baked_alive(s: dict, max_rounds: int) -> torch.Tensor:
    return s["valid"] & (s["T"] >= s["minT"]) & (s["t"] < s["t1"]) & (s["chunks"] < max_rounds)


def resolve_baked_knobs(cull=None, fine=None, cull_heads=None, fine_heads=None, adv=None):
    """The gather-strategy knobs, explicit or from the environment:
    cull "coarse" (the half-resolution bit probe, default), "brick" (the
    chain-deduped brick probe) or "fine" (full resolution); fine "row" (one
    row a survivor, default) or "brick" (chain-deduped brick rows);
    cull_heads (16) and fine_heads (0: half the survivors) size the dedup
    head budgets; adv "dda" (the serial occupancy advance, default),
    "scout" (a batched quarter-resolution probe walk) or "dist" (chained
    distance-field jumps, which also replace the frame's initial advance
    and retreat)."""
    cull = cull or os.environ.get("SIENERF_CULL", "coarse")
    fine = fine or os.environ.get("SIENERF_FINE", "row")
    if cull_heads is None:
        cull_heads = int(os.environ.get("SIENERF_CULL_HEADS", "16"))
    if fine_heads is None:
        fine_heads = int(os.environ.get("SIENERF_FINE_HEADS", "0"))
    adv = adv or os.environ.get("SIENERF_ADV", "dda")
    return cull, fine, cull_heads, fine_heads, adv


def _cull_keep_trilinear(grid, meta, pos, valid):
    """The trilinear cull: the 5^3-pooled half-resolution sidecar covers all
    8 corners of a sample's cell."""
    R, K = meta["resolution"], meta["n_cascades"]
    flat2, oob2, _ = nearest_vertex_ids(R // 2, K, pos)
    return valid & ~oob2 & lookup_bits(grid["bits2t"], flat2)


def _cull_keep(grid, meta, pos, valid, cull: str, cull_heads: int):
    """The candidate cull -> (keep mask, full-resolution nearest-vertex ids,
    on which the run merge works whichever sidecar is probed)."""
    R, K = meta["resolution"], meta["n_cascades"]
    flat, oob, _ = nearest_vertex_ids(R, K, pos)
    if cull == "brick" and "bits2b" in grid:
        R2v = R // 2 + 1
        k3, oob2, m2 = nearest_vertex_coords(R // 2, K, pos)
        row, off = brick_probe_ids(k3, m2, (K, R2v, R2v, R2v))
        keep = valid & ~oob2 & lookup_bits_brick(grid["bits2b"], row, off, cull_heads)
    elif cull != "fine" and "bits2" in grid:
        flat2, oob2, _ = nearest_vertex_ids(R // 2, K, pos)
        keep = valid & ~oob2 & lookup_bits(grid["bits2"], flat2)
    else:
        keep = valid & ~oob & lookup_bits(grid["bits"], flat)
    return keep, flat


def _scout_advance(grid, meta, o, d, t, t1, n_scout: int):
    """Batched empty-space advance: probe `n_scout` points at spacing
    h = 4/R (one cascade-0 quarter cell) against the dilated quarter-res
    sidecar and move to one h before the first live probe, or past the
    walk when none is live."""
    R, K = meta["resolution"], meta["n_cascades"]
    R4 = R // 4
    h = _f32(4.0 / R)
    j = torch.arange(n_scout, dtype=torch.float32, device=t.device)
    ts = t[:, None] + j[None, :] * h  # (A, S)
    pos = o[:, None, :] + ts[..., None] * d[:, None, :]
    m = mip_from_pos(pos, K)
    u = (pos - 0.5) / cascade_extent(m).to(pos.device)[..., None] + 0.5
    oob = ((u < 0.0) | (u >= 1.0)).any(dim=-1)
    c3 = torch.floor(u * R4).to(torch.int64).clamp(0, R4 - 1)
    flat = m * (R4 * R4 * R4) + (c3[..., 0] * R4 + c3[..., 1]) * R4 + c3[..., 2]
    live = lookup_bits(grid["bits3"], flat) & ~oob & (ts < t1[:, None])
    t_first = torch.where(live, ts, float("inf")).amin(dim=1)
    t_new = torch.where(torch.isfinite(t_first), torch.maximum(t, t_first - h),
                        t + _f32((n_scout - 1) * h))
    return torch.minimum(t_new, t1)


def _dist_jump(grid, meta, pos):
    """One distance-field probe: world positions -> a safe advance (world
    units), (D-1) cells of the position's cascade, clamped to the room left
    inside its cube.  As in the JAX package, the field covers occupancy at
    the position's cascade only; the serial DDA stops on cells occupied at
    max(position's, step's) cascade, so with cone stepping a jump may
    sample slightly differently (the 30 dB frame check bounds it)."""
    K = meta["n_cascades"]
    G = round((grid["dist3d"].shape[0] * 16 / K) ** (1.0 / 3.0))
    m = mip_from_pos(pos, K)
    ext = cascade_extent(m).to(pos.device)
    u = (pos - 0.5) / ext[..., None] + 0.5
    inb = ((u >= 0.0) & (u < 1.0)).all(dim=-1)
    c3 = torch.floor(u * G).to(torch.int64).clamp(0, G - 1)
    flat = m * (G * G * G) + (c3[..., 0] * G + c3[..., 1]) * G + c3[..., 2]
    D = lookup_bytes(grid["dist3d"], flat)
    pitch = ext / G
    rem = ext * 0.5 - (pos - 0.5).abs().amax(dim=-1)
    jump = torch.minimum(torch.clamp(D - 1, min=0).float() * pitch, torch.clamp(rem, min=0.0))
    return torch.where(inb, jump, 0.0)


def _dist_advance(grid, meta, o, d, t, t1, n_jumps: int):
    """`n_jumps` chained distance-field jumps from t towards t1."""
    for _ in range(n_jumps):
        t = torch.minimum(t + _dist_jump(grid, meta, o + t[:, None] * d), t1)
    return t


def _dist_retreat(grid, meta, o, d, t0, t1, n_jumps: int):
    """The same jumps backwards from the exit point (the Chebyshev distance
    is isotropic)."""
    for _ in range(n_jumps):
        t1 = torch.maximum(t1 - _dist_jump(grid, meta, o + t1[:, None] * d), t0)
    return t1


def _merge_bound(meta, step_scale: float) -> int:
    """The longest run of candidates on one vertex: the sqrt(3) diagonal of
    the coarsest cascade's Voronoi cell over the smallest step (float64, as
    the JAX package computes it in numpy)."""
    R, K = meta["resolution"], meta["n_cascades"]
    return int(np.ceil(np.sqrt(3.0) * (2 ** (K - 1) / R)
                       / (MIN_CONE_STEPSIZE * step_scale))) + 2


def _march_eval_once(engine, params, grid, meta, words, o, d, t, t1, T, minT, alive,
                     P: int, evals: int, step_scale: float, adv_iters: int, knobs,
                     impl: str = "kernel", clock=_NO_CLOCK):
    """One march/eval pass over a fixed ray set: advance past empty space,
    P closed-form candidates, cull, same-vertex run merge, stable compaction
    to `evals` survivors, one feature gather a survivor, colour MLP,
    composite.  -> (rgb_add (A, 3), opacity_add (A,), T_out (A,), t_next
    (A,), best_w, best_t, n_kept (A,), overflow (A,))."""
    cull, fine, cull_heads, fine_heads, adv_mode = knobs
    if adv_iters > 0:
        if adv_mode == "dist" and "dist3d" in grid:
            t = _dist_advance(grid, meta, o, d, t, t1, max(2, adv_iters // 4))
        elif adv_mode == "scout" and "bits3" in grid:
            t = _scout_advance(grid, meta, o, d, t, t1, 2 * adv_iters)
        else:
            t = advance_to_occupied(engine.march, words, o, d, t, t1, adv_iters)
    clock.phase("advance")
    ts, dts, t_end = _candidate_chain(t, engine.march.cone_angle, P, step_scale)
    valid = alive[:, None] & (ts < t1[:, None])
    pos = o[:, None, :] + ts[..., None] * d[:, None, :]
    no_overflow = torch.zeros(ts.shape[:1], dtype=torch.bool, device=ts.device)
    if evals >= P or (meta["mode"] != "nearest" and "bits2t" not in grid):
        # every candidate pays the feature gather
        clock.phase("cull")
        kept, ts_c, dts_c, overflow, t_next = valid, ts, dts, no_overflow, t_end
    else:
        if meta["mode"] != "nearest":
            # trilinear samples vary within a cell: no run merge
            keep = _cull_keep_trilinear(grid, meta, pos, valid)
        else:
            keep, flat = _cull_keep(grid, meta, pos, valid, cull, cull_heads)
            bound = _merge_bound(meta, step_scale)
            if bound < P:
                keep, dts = merge_same_vertex_runs(flat, keep, dts, max_run=bound)
        clock.phase("cull")
        kept, ts_c, dts_c = compact_candidates(keep, evals + 1, ts, dts)
        overflow = kept[:, evals]
        t_next = torch.where(overflow, ts_c[:, evals], t_end)
        kept, ts_c, dts_c = kept[:, :evals], ts_c[:, :evals], dts_c[:, :evals]
        clock.phase("compact")
    if fine == "brick" and meta["mode"] == "nearest" and "brows" in grid:
        # survivors sharing a 2x2x4 brick share one gather; survivors past
        # the head budget roll the ray back to the first of them (exact, as
        # the eval overflow)
        n_heads = fine_heads or max(4, ts_c.shape[1] // 2)
        pos_c = o[:, None, :] + ts_c[..., None] * d[:, None, :]
        raw, fovf = baked_features_brick(grid["brows"], grid["scale"], meta["resolution"],
                                         meta["n_cascades"], pos_c, n_heads, impl)
        fovf = fovf & kept
        any_ovf = fovf.any(dim=1)
        t_first = torch.where(fovf, ts_c, float("inf")).amin(dim=1)
        t_next = torch.where(any_ovf & (t_first < t_next), t_first, t_next)
        overflow = overflow | any_ovf
        kept = kept & ~fovf
        clock.phase("gather")
        rgb, dens = _colors_from_raw(engine, params, raw.reshape(-1, raw.shape[-1]), d,
                                     ts_c.shape, kept)
        clock.phase("mlp")
    else:
        rgb, dens = _baked_sample_colors(engine, params, grid, meta, o, d, ts_c, kept, impl,
                                         clock)
    rgb_sum, opacity, T_out, bw, bt = composite_chunk(rgb, dens, ts_c, dts_c, kept, T, minT)
    n_kept = kept.sum(dim=1)
    clock.phase("composite")
    return rgb_sum, opacity, T_out, t_next, bw, bt, n_kept, overflow


def _initial_span(engine, grid, meta, words, o, d, t0, t1, iters: int, adv_mode: str):
    """The frame-init advance and retreat: distance-field jumps for
    adv="dist", else the serial DDA from both ends."""
    if iters > 0 and adv_mode == "dist" and "dist3d" in grid:
        t0 = _dist_advance(grid, meta, o, d, t0, t1, max(3, iters // 8))
        t1 = _dist_retreat(grid, meta, o, d, t0, t1, max(3, iters // 8))
    elif iters > 0:
        t0 = advance_to_occupied(engine.march, words, o, d, t0, t1, iters)
        # sky and background rays collapse to an empty span
        t1 = retreat_to_occupied(engine.march, words, o, d, t0, t1, iters)
    return t0, t1


@torch.no_grad()
def render_rays_baked(engine, params, grid, meta, bitfield, o, d, P: int = 128,
                      evals: int = 32, step_scale: float = 1.0, max_rounds: int = 24,
                      adv_iters: int = 16, min_transmittance=None, near=None, t_cap=None,
                      cull=None, fine=None, cull_heads=None, fine_heads=None, adv=None,
                      init_advance_iters: int = 0, impl: str = "kernel"):
    """A fixed ray batch through the bake -> (rgb (N, 3), opacity (N,),
    z-depth (N,)).  `d` may be unnormalised camera rays (z = 1): the march
    runs along the unit direction and depth is t / |d|.  `t_cap` (per ray,
    in units of the unnormalised d) bounds the march, as the hybrid frame
    stops rays at the mesh."""
    knobs = resolve_baked_knobs(cull, fine, cull_heads, fine_heads, adv)
    if near is None:
        near = max(NERF_RENDERING_NEAR_DISTANCE, engine.near_distance)
    minT = float(engine.render_min_transmittance if min_transmittance is None
                 else min_transmittance)
    dn = torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    d = d / dn
    t0, t1 = engine._aabb_times(o, d, near)
    blo, bhi = occupied_bbox(bitfield)
    btmin, btmax = ray_box_times(o, d, blo, bhi)
    words = pack_occupancy(bitfield)
    t0 = torch.maximum(t0, btmin)
    t1 = torch.minimum(t1, btmax)
    if t_cap is not None:
        t1 = torch.minimum(t1, t_cap * dn[:, 0])
    t1 = torch.maximum(t1, t0)
    t0, t1 = _initial_span(engine, grid, meta, words, o, d, t0, t1, init_advance_iters,
                           knobs[4])
    A, dev = o.shape[0], o.device
    t, T = t0, torch.ones((A,), dtype=torch.float32, device=dev)
    rgb = torch.zeros((A, 3), dtype=torch.float32, device=dev)
    op = torch.zeros((A,), dtype=torch.float32, device=dev)
    bw = torch.zeros((A,), dtype=torch.float32, device=dev)
    bt = torch.zeros((A,), dtype=torch.float32, device=dev)
    for _ in range(max_rounds):
        alive = (T >= minT) & (t < t1)
        if not bool(alive.any()):
            break
        rgb_sum, opacity, T_out, t_next, w, wt, _, _ = _march_eval_once(
            engine, params, grid, meta, words, o, d, t, t1, T, minT, alive, P, evals,
            step_scale, adv_iters, knobs, impl)
        better = alive & (w > bw)
        t = torch.where(alive, t_next, t)
        T = torch.where(alive, T_out, T)
        rgb = rgb + torch.where(alive[:, None], rgb_sum, 0.0)
        op = op + torch.where(alive, opacity, 0.0)
        bw = torch.where(better, w, bw)
        bt = torch.where(better, wt, bt)
    return rgb, op, bt / torch.clamp(dn[:, 0], min=1e-9)


def _baked_accum_pass(engine, s, params, grid, meta, words, P, evals, step_scale,
                      max_rounds, adv_iters, knobs, impl, clock):
    """One march/eval pass accumulated into the streaming state."""
    was_alive = _baked_alive(s, max_rounds)
    rgb_sum, opacity, T_out, t_next, bw, bt, n_kept, overflow = _march_eval_once(
        engine, params, grid, meta, words, s["o"], s["d"], s["t"], s["t1"], s["T"],
        s["minT"], was_alive, P, evals, step_scale, adv_iters, knobs, impl, clock)
    better = was_alive & (bw > s["bw"])
    return dict(
        s,
        rgb=s["rgb"] + torch.where(was_alive[:, None], rgb_sum, 0.0),
        op=s["op"] + torch.where(was_alive, opacity, 0.0),
        bw=torch.where(better, bw, s["bw"]),
        bt=torch.where(better, bt, s["bt"]),
        t=torch.where(was_alive, t_next, s["t"]),
        T=torch.where(was_alive, T_out, s["T"]),
        chunks=s["chunks"] + was_alive.to(torch.int64),
        used=s["used"] + n_kept,
        # frame-wide counts: rays processed, fine evals, overflow rollbacks
        n_ray_rounds=s["n_ray_rounds"] + was_alive.sum(),
        n_evals=s["n_evals"] + n_kept.sum(),
        n_overflow=s["n_overflow"] + (overflow & was_alive).sum(),
    )


@torch.no_grad()
def render_frame_baked(engine, params, bitfield, grid, camera_matrix, focal_length, *,
                       width: int, height: int, resolution: int, mode: str,
                       n_cascades: int = 1, tile: int = 1 << 16, candidates: int = 128,
                       evals: int = 32, step_scale: float = 1.0, max_rounds: int = 24,
                       advance_iters: int = 16, flush_every: int = 1,
                       init_advance_iters: int | None = 32, screen_center=(0.5, 0.5),
                       background=(0.0, 0.0, 0.0), min_transmittance=None, pixel_offset=None,
                       t_phase=None, return_stats: bool = False, cull=None, fine=None,
                       cull_heads=None, fine_heads=None, adv=None, impl: str = "kernel",
                       stats: dict | None = None, extra_row=None):
    """A full baked frame -> (rgba (H, W, 4), depth (H, W)), and with
    return_stats an int64 tensor [rounds, ray-rounds, evals, overflows].
    `extra_row` shades with another view's extra dims (default view 0's).

    `resolution`, `mode` and `n_cascades` are the bake's meta.  `tile` is
    the number of ray slots.  `init_advance_iters` sizes the frame-init
    advance and retreat (None: the engine's).  `t_phase` shifts every
    ray's candidate chain by t_phase * dmin after the advance (the spp
    jitter).  `impl="plain"` gathers with the plain index_select on the
    card.  `stats`, when given, receives the rounds (march/eval
    passes), ray-rounds, evals and overflows, the seconds the host waited
    for the device's per-round answer, and, with stats["sync_phases"] set,
    the seconds of each of BAKED_PHASES."""
    knobs = resolve_baked_knobs(cull, fine, cull_heads, fine_heads, adv)
    meta = {"resolution": resolution, "mode": mode, "n_cascades": n_cascades}
    dev = bitfield.device
    params = with_extra_row(params, extra_row)
    if stats is not None:
        stats.update(rounds=0, host_wait_s=0.0)
    clock = PhaseClock(stats, dev, BAKED_PHASES)
    n = width * height
    A = min(tile, max(256, n))
    off = (0.5, 0.5) if pixel_offset is None else pixel_offset
    cam_spec = (width, height, focal_length, camera_matrix, screen_center, off)
    bounds = occupied_bbox(bitfield)
    words = pack_occupancy(bitfield)
    o_a, d_a, dn_a, t0_a, t1_a = engine._frame_make_rays(
        torch.arange(n, device=dev), n, cam_spec, bounds)
    clock.phase("setup")
    ia = engine.init_advance_iters if init_advance_iters is None else init_advance_iters
    t0_a, t1_a = _initial_span(engine, grid, meta, words, o_a, d_a, t0_a, t1_a, ia, knobs[4])
    if t_phase is not None:
        # the spp chain-phase jitter, after the advance: it dithers the
        # quadrature, not the skipping
        phase = torch.as_tensor(t_phase, dtype=torch.float32, device=dev)
        t0_a = torch.minimum(t0_a + phase * _f32(MIN_CONE_STEPSIZE) * _f32(step_scale), t1_a)
    rays_pre = engine._frame_pack_rays(o_a, d_a, dn_a, t0_a, t1_a)
    clock.phase("init_advance")

    ids0 = torch.arange(A, device=dev)
    o0, d0, dn0, t00, t10 = engine._frame_take_rays(ids0, n, rays_pre)
    zero = torch.zeros((A,), dtype=torch.float32, device=dev)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    s = dict(
        ids=ids0, o=o0, d=d0, dnorm=dn0, t=t00, t1=t10,
        T=torch.ones((A,), dtype=torch.float32, device=dev),
        rgb=torch.zeros((A, 3), dtype=torch.float32, device=dev),
        op=zero, bw=zero, bt=zero, valid=ids0 < n,
        chunks=torch.zeros((A,), dtype=torch.int64, device=dev),
        used=torch.zeros((A,), dtype=torch.int64, device=dev),
        cursor=torch.full((), A, dtype=torch.int64, device=dev),
        minT=float(engine.render_min_transmittance if min_transmittance is None
                   else min_transmittance),
        out=torch.zeros((n + 1, 5), dtype=torch.float32, device=dev),
        n_ray_rounds=count, n_evals=count, n_overflow=count,
    )
    clock.phase("setup")

    def alive_fn(st):
        return _baked_alive(st, max_rounds)

    n_rounds = 0
    while clock.any_alive(alive_fn(s)):
        s2 = s
        for _ in range(flush_every):
            s2 = _baked_accum_pass(engine, s2, params, grid, meta, words, candidates, evals,
                                   step_scale, max_rounds, advance_iters, knobs, impl, clock)
        # rays that finish mid-group idle until the group's flush: ids, valid
        # and the cursor change only there, so the group's first state is
        # the flush's
        s = engine._frame_flush_refill(s, s2, n, rays_pre, alive_fn)
        clock.phase("flush")
        n_rounds += flush_every
    out = s["out"][:n]
    rgb, opacity, depth = out[:, :3], out[:, 3], out[:, 4]
    bg = torch.as_tensor(np.asarray(background, np.float32), device=dev)
    if "envmap" in params:
        bg = background_behind_envmap(params["envmap"], d_a, bg)
    rgb = rgb + (1.0 - opacity)[:, None] * bg
    rgba = torch.cat([rgb, opacity[:, None]], dim=-1)
    clock.phase("setup")
    img = rgba.reshape(height, width, 4), depth.reshape(height, width)
    counts = torch.stack([torch.tensor(n_rounds, device=dev), s["n_ray_rounds"],
                          s["n_evals"], s["n_overflow"]])
    if stats is not None:
        stats.update(rounds=n_rounds,
                     **dict(zip(("ray_rounds", "evals", "overflows"), counts[1:].tolist())))
    return img + (counts,) if return_stats else img


@torch.no_grad()
def render_frame_baked_multichip(engine, params, bitfield, grid, camera_matrix, focal_length,
                                 mesh, *, width: int, height: int, resolution: int, mode: str,
                                 n_cascades: int = 1, tile: int = 1 << 13,
                                 candidates: int = 128, evals: int = 32,
                                 step_scale: float = 1.0, background=(0.0, 0.0, 0.0),
                                 screen_center=(0.5, 0.5), min_transmittance=None,
                                 cull=None, fine=None, adv=None, init_advance_iters: int = 32):
    """A baked frame with its rays sharded over the mesh's ranks -> rgba
    (H, W, 4) and depth (H, W) on every rank.  params, bitfield and the
    bake are the same on every rank (replicated: every gather stays in its
    own device's memory); each rank runs render_rays_baked over its tiles,
    with the single-device frame's entry advance (`init_advance_iters`),
    and the frame is gathered and filled as render_frame_multichip's."""
    meta = {"resolution": resolution, "mode": mode, "n_cascades": n_cascades}
    uv = pixel_grid_uv(width, height, bitfield.device).reshape(-1, 2)
    o, d = uv_to_ray(uv, (width, height), focal_length, camera_matrix, screen_center,
                     engine.lens)

    def ray_fn(oo, dd):
        return render_rays_baked(engine, params, grid, meta, bitfield, oo, dd, P=candidates,
                                 evals=evals, step_scale=step_scale,
                                 min_transmittance=min_transmittance, cull=cull, fine=fine,
                                 adv=adv, init_advance_iters=init_advance_iters)

    rgb, op, depth = NerfEngine._sharded_ray_fanout(mesh, tile, o, d, ray_fn)
    rgb = NerfEngine._background_fill(rgb, op, d, params, background)
    rgba = torch.cat([rgb, op[:, None]], dim=-1)
    return rgba.reshape(height, width, 4), depth.reshape(height, width)
