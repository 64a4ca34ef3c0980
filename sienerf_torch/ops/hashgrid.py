"""Multiresolution hash-grid encoding (port of the JAX package's
ops/hashgrid.py: HashGridConfig, _static_level_data, _geometry_cell,
init_hashgrid_params, hashgrid_encode for cell- and corner-layout tables
with their backwards, hashgrid_stats, and the render-side packed tables
pack_table_bf16 / hashgrid_encode_bf16 and pack_table_fp8 /
hashgrid_encode_fp8).

The JAX package carries packed render tables as f32 bitcasts for its TPU
gathers; here a bf16 table is a bfloat16 tensor (L, T, C*F) and an fp8
table its e4m3 bytes as uint8 (L, T, C*F), the same bits
(convert.params_from_jax maps one to the other).

Semantics (tcnn):
  scale_l = base_resolution * per_level_scale**l - 1
  res_l   = ceil(scale_l) + 1
  pos_l   = pos * scale_l + 0.5 ; cell = floor(pos_l), frac = pos_l - cell
  index   = dense stride where the level's cells fit the table, else
            (x * 1) ^ (y * 2654435761) ^ (z * 805459861)  (mod table_size)

The table is in the "cell" layout: one row per interpolation cell holding
its 2^D corner vectors, or in the "corner" layout, tcnn's vertex table
(L, T, F) that imported .ingp snapshots keep (a config picks it with
`encoding.layout: "corner"`).  The packed render tables take the cell
layout only, as in the JAX package.  The hash is uint32 multiply-XOR;
torch's uint32 arithmetic is incomplete, so it is computed in int64 and
masked to 32 bits after every product, which gives the same bits.

The backward (`HashGridEncode`, a torch.autograd.Function) follows the
reference's default mode, "bf16": each sample's contribution w * g to its
cell row is rounded to bf16 before it is summed into d_table.  The sum
itself runs in f32, where the reference sums in bf16, and in a fixed order
(ops/fixed_order.py: the contributions of all levels sorted by row, each
row's summed pairwise), so that one seed trains to one result on the card
too.  bf16 sums in a fixed order would not reproduce the reference's
either, and its own test (tests/test_hashgrid.py::test_bwd_bf16_mode_close)
holds bf16 mode to the f32 backward within 2 % of the largest gradient,
which bounds the gap.
The corner layout's backward (`HashGridEncodeCorner`) follows the
reference's corner branch: each (sample, level, corner) contribution w * g
is summed into its vertex row in f32, unrounded, in the same fixed order
(one stable sort of all levels' rows, each row's run summed pairwise).
The position gradient d_pos is computed only when pos requires a
gradient (render mode `normals`, the camera learners, SDF normals); its
formula is the same for both layouts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from sienerf_torch.ops.fixed_order import segment_sum_sorted

_PRIMES = (1, 2654435761, 805459861, 3674653429)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    n_dims: int = 3
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    grid_type: str = "Hash"  # "Dense" forces stride indexing at every level
    layout: str = "cell"

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    def level_scale(self, level: int) -> float:
        return self.base_resolution * (self.per_level_scale ** level) - 1.0

    def level_resolution(self, level: int) -> int:
        return int(math.ceil(self.level_scale(level))) + 1

    def level_is_dense(self, level: int) -> bool:
        if self.grid_type == "Dense":
            return True
        res = self.level_resolution(level)
        rows = max(res - 1, 1) ** self.n_dims if self.layout == "cell" \
            else res ** self.n_dims
        return rows <= self.table_size

    @staticmethod
    def from_network_config(enc: dict, n_dims: int = 3,
                            aabb_scale: float = 1.0) -> "HashGridConfig":
        """From a tcnn encoding dict.  Without an explicit per_level_scale
        the finest level spans `2048 * aabb_scale` cells across the unit
        box (NGP's auto sizing)."""
        n_levels = int(enc.get("n_levels", 16))
        base = int(enc.get("base_resolution", 16))
        if "per_level_scale" in enc:
            pls = float(enc["per_level_scale"])
        else:
            desired = 2048.0 * aabb_scale
            pls = float(np.exp(np.log(desired / base) / max(n_levels - 1, 1)))
        return HashGridConfig(
            n_dims=n_dims,
            n_levels=n_levels,
            n_features_per_level=int(enc.get("n_features_per_level", 2)),
            log2_hashmap_size=int(enc.get("log2_hashmap_size", 19)),
            base_resolution=base,
            per_level_scale=pls,
            grid_type="Dense" if enc.get("otype", "HashGrid").lower()
            .startswith("dense") else "Hash",
            layout=enc.get("layout", "cell"),
        )


def _static_level_data(config: HashGridConfig):
    """Per-level constants as numpy: f32 scales, resolutions, dense flags,
    (L, D) index multipliers (uint32 values held in int64)."""
    L, D = config.n_levels, config.n_dims
    scales = np.asarray([config.level_scale(l) for l in range(L)], np.float32)
    res = np.asarray([config.level_resolution(l) for l in range(L)], np.int64)
    dense = np.asarray([config.level_is_dense(l) for l in range(L)], bool)
    mult = np.zeros((L, D), np.int64)
    for l in range(L):
        if dense[l]:
            stride_base = int(res[l]) - 1 if config.layout == "cell" else int(res[l])
            s = 1
            for d in range(D):
                mult[l, d] = s % (1 << 32)
                s *= max(stride_base, 1)
        else:
            for d in range(D):
                mult[l, d] = _PRIMES[d] % (1 << 32)
    return scales, res, dense, mult


def _geometry_cell(config: HashGridConfig, pos: torch.Tensor, with_per_dim: bool = False):
    """Cell-layout geometry: one table row per (sample, level) and the
    trilinear corner weights.  pos (N, D) in [0,1]^D ->
    (idx (N, L) int64 in [0, T), w (N, L, 2^D) f32), and with
    `with_per_dim` also the per-dimension factors of w (N, L, 2^D, D)."""
    L, D = config.n_levels, config.n_dims
    scales, res, dense, mult = _static_level_data(config)
    dev = pos.device
    sc = torch.as_tensor(scales, device=dev)
    # f32 (float64 stays float64, for finite-difference checks)
    x = pos.to(torch.promote_types(pos.dtype, torch.float32))[:, None, :] \
        * sc[None, :, None] + 0.5  # (N, L, D)
    x_floor = torch.floor(x)
    frac = x - x_floor
    cell_max = torch.as_tensor(
        np.maximum(res - 2, 0).astype(np.float32), device=dev)[None, :, None]
    base = torch.minimum(torch.clamp(x_floor, min=0.0), cell_max).to(torch.int64)

    mult_t = torch.as_tensor(mult, device=dev)  # (L, D)
    dense_t = torch.as_tensor(dense, device=dev)[None, :]
    idx = None
    for d in range(D):
        term = (base[..., d] * mult_t[None, :, d]) & _U32
        if idx is None:
            idx = term
        else:
            idx = torch.where(dense_t, (idx + term) & _U32, idx ^ term)
    idx = idx & (config.table_size - 1)

    # corner c's offset along dim d is bit d of c
    offs = torch.as_tensor(
        [[(c >> d) & 1 for d in range(D)] for c in range(1 << D)],
        dtype=torch.bool, device=dev)
    f = frac[:, :, None, :]  # (N, L, 1, D)
    per_dim = torch.where(offs[None, None], f, 1.0 - f)  # (N, L, C, D)
    w = per_dim[..., 0]
    for d in range(1, D):
        w = w * per_dim[..., d]
    if with_per_dim:
        return idx, w, per_dim
    return idx, w


def _rows3(config: HashGridConfig, table: torch.Tensor) -> torch.Tensor:
    """A cell table, (L, T, C, F) or flat (L, T*C*F), as rows (L, T, C*F)."""
    return table.reshape(config.n_levels, config.table_size,
                         (1 << config.n_dims) * config.n_features_per_level)


def _pad_cell_table(config: HashGridConfig, table: torch.Tensor) -> torch.Tensor:
    """(L, T, C, F) -> (L, T, C*Fp) with each corner's features zero-padded
    so that a row holds at least 32 values (the layout of the backward
    scatter)."""
    L, T, C, F = table.shape
    Fp = max(F, max(32 // C, 1))
    if Fp != F:
        table = torch.nn.functional.pad(table, (0, Fp - F))
    return table.reshape(L, T, C * Fp)


def _interpolate(config: HashGridConfig, pos: torch.Tensor, level_rows) -> torch.Tensor:
    """Trilinear blend of each level's cell row.  `level_rows(l, idx)` gives
    the (N, C, F) f32 corner features of level l's rows idx (N,) int64.
    pos (N, D) in [0,1]^D -> (N, L*F) f32.  One gather per level: each row
    holds its cell's 2^D corner vectors."""
    L, F = config.n_levels, config.n_features_per_level
    idx, w = _geometry_cell(config, pos)
    outs = [(level_rows(l, idx[:, l]) * w[:, l, :, None]).sum(dim=1) for l in range(L)]
    return torch.stack(outs, dim=1).reshape(pos.shape[0], L * F)


def _require_cell(config: HashGridConfig) -> None:
    if config.layout != "cell":
        raise NotImplementedError(
            "the packed render tables take the cell layout only, as in the JAX package "
            "(its pack_table_bf16 / pack_table_fp8 assert it); a corner-layout table "
            "renders and trains from its f32 table")


def _geometry_corner(config: HashGridConfig, pos: torch.Tensor,
                     with_per_dim: bool = False):
    """Corner-layout geometry (tcnn's vertex table): one row per (sample,
    level, corner).  pos (N, D) in [0,1]^D -> (idx (N, L, 2^D) int64 in
    [0, T), w (N, L, 2^D) f32), and with `with_per_dim` also the
    per-dimension factors of w (N, L, 2^D, D)."""
    L, D = config.n_levels, config.n_dims
    scales, res, dense, mult = _static_level_data(config)
    dev = pos.device
    sc = torch.as_tensor(scales, device=dev)
    # f32 (float64 stays float64, for finite-difference checks)
    x = pos.to(torch.promote_types(pos.dtype, torch.float32))[:, None, :] \
        * sc[None, :, None] + 0.5  # (N, L, D)
    x_floor = torch.floor(x)
    frac = x - x_floor
    res_m1 = torch.as_tensor((res - 1).astype(np.float32), device=dev)[None, :, None]
    base = torch.minimum(torch.clamp(x_floor, min=0.0), res_m1).to(torch.int64)
    offs = torch.as_tensor([[(c >> d) & 1 for d in range(D)] for c in range(1 << D)],
                           dtype=torch.int64, device=dev)  # (C, D)
    res_i = torch.as_tensor(res - 1, device=dev)[None, :, None]
    mult_t = torch.as_tensor(mult, device=dev)  # (L, D)
    dense_t = torch.as_tensor(dense, device=dev)[None, :, None]
    idx = None
    for d in range(D):
        corner = torch.minimum(base[..., d, None] + offs[None, None, :, d], res_i)
        term = (corner * mult_t[None, :, None, d]) & _U32
        idx = term if idx is None else torch.where(dense_t, (idx + term) & _U32, idx ^ term)
    idx = idx & (config.table_size - 1)
    f = frac[:, :, None, :]
    per_dim = torch.where(offs[None, None].bool(), f, 1.0 - f)  # (N, L, C, D)
    w = per_dim[..., 0]
    for d in range(1, D):
        w = w * per_dim[..., d]
    if with_per_dim:
        return idx, w, per_dim
    return idx, w


def _encode_corner(config: HashGridConfig, table: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Forward of the corner layout from the f32 (L, T, F) table (or the
    same flattened to (L, T*F)) -> (N, L*F) f32."""
    L, F, T = config.n_levels, config.n_features_per_level, config.table_size
    idx, w = _geometry_corner(config, pos)
    rows = table.reshape(L, T, F)
    outs = [(rows[l].index_select(0, idx[:, l].reshape(-1)).reshape(-1, 1 << config.n_dims, F)
             * w[:, l, :, None]).sum(dim=1) for l in range(L)]
    return torch.stack(outs, dim=1).reshape(pos.shape[0], L * F)


def _corner_features(config: HashGridConfig, table: torch.Tensor,
                     idx: torch.Tensor) -> torch.Tensor:
    """The vertex rows of each (sample, level, corner): idx (N, L, C) ->
    (N, L, C, F), one gather a level."""
    L, F, T = config.n_levels, config.n_features_per_level, config.table_size
    N, C = idx.shape[0], idx.shape[2]
    rows = table.reshape(L, T, F)
    return torch.stack([rows[l].index_select(0, idx[:, l].reshape(-1)).reshape(N, C, F)
                        for l in range(L)], dim=1)


def init_hashgrid_params(config: HashGridConfig, generator: torch.Generator,
                         device=None) -> torch.Tensor:
    """tcnn's initial features: uniform in [-1e-4, 1e-4], shape (L, T, C, F)
    for the cell layout, (L, T, F) for the corner layout."""
    shape = (config.n_levels, config.table_size, 1 << config.n_dims,
             config.n_features_per_level)
    if config.layout != "cell":
        shape = (config.n_levels, config.table_size, config.n_features_per_level)
    return torch.empty(shape, dtype=torch.float32, device=device).uniform_(
        -1e-4, 1e-4, generator=generator)


class HashGridEncode(torch.autograd.Function):
    """hashgrid_encode with the reference's backward (`_encode_bwd_impl`,
    default mode "bf16", cell layout): d_table sums each sample's
    contribution w * g, rounded to bf16, into its cell row in f32; d_pos
    is the analytic position gradient."""

    @staticmethod
    def forward(ctx, table, pos, config):
        C, F = 1 << config.n_dims, config.n_features_per_level
        rows = _rows3(config, table)
        ctx.config = config
        ctx.save_for_backward(table, pos)
        return _interpolate(
            config, pos, lambda l, idx: rows[l].index_select(0, idx).reshape(-1, C, F))

    @staticmethod
    def backward(ctx, g):
        table, pos = ctx.saved_tensors
        config = ctx.config
        L, F, D = config.n_levels, config.n_features_per_level, config.n_dims
        C, T, N = 1 << D, config.table_size, pos.shape[0]
        gl = g.to(torch.promote_types(g.dtype, torch.float32)).reshape(N, L, F)
        want_pos = ctx.needs_input_grad[1]
        geo = _geometry_cell(config, pos, with_per_dim=want_pos)
        idx, w = geo[0], geo[1]
        d_table = d_pos = None
        if ctx.needs_input_grad[0]:
            # every level's contributions sorted by row once, then each
            # row's summed pairwise in sorted order: one result per input
            keys = idx + torch.arange(L, device=pos.device)[None, :] * T  # (N, L)
            skeys, order = torch.sort(keys.reshape(-1), stable=True)
            contrib = w.reshape(N * L, C)[order, :, None] * gl.reshape(N * L, F)[order, None, :]
            contrib = contrib.reshape(N * L, C * F).to(torch.bfloat16).float()
            d = segment_sum_sorted(contrib, skeys, L * T)
            d_table = d.reshape(table.shape).to(table.dtype)
        if want_pos:
            rows = _rows3(config, table)
            cf = torch.stack([rows[l].index_select(0, idx[:, l]).reshape(N, C, F)
                              for l in range(L)], dim=1)  # (N, L, C, F)
            d_pos = _position_gradient(config, cf, gl, w, geo[2]).to(pos.dtype)
        return d_table, d_pos, None


def _position_gradient(config: HashGridConfig, cf: torch.Tensor, gl: torch.Tensor,
                       w: torch.Tensor, per_dim: torch.Tensor) -> torch.Tensor:
    """d_pos (N, D) of either layout from the corner features cf
    (N, L, C, F), the output gradient gl (N, L, F), the weights w
    (N, L, C) and their per-dimension factors (N, L, C, D)."""
    D = config.n_dims
    C = 1 << D
    fdotg = (cf * gl[:, :, None, :]).sum(dim=-1)  # (N, L, C)
    # d w / d pos_d = sign(corner offset) * (the other factors) * scale
    sign = torch.tensor([[1.0 if (c >> d) & 1 else -1.0 for d in range(D)]
                         for c in range(C)], device=cf.device)
    scales = torch.as_tensor(_static_level_data(config)[0], device=cf.device)
    cols = []
    for d in range(D):
        others = [k for k in range(D) if k != d]
        prod_others = torch.ones_like(w)
        if others:
            prod_others = per_dim[..., others[0]]
            for k in others[1:]:
                prod_others = prod_others * per_dim[..., k]
        dw = sign[None, None, :, d] * prod_others * scales[None, :, None]
        cols.append((fdotg * dw).sum(dim=(1, 2)))
    return torch.stack(cols, dim=-1)


class HashGridEncodeCorner(torch.autograd.Function):
    """hashgrid_encode of a corner-layout table (L, T, F), or its 2-D
    flattening (L, T*F), with the reference's corner backward
    (`_encode_bwd_impl`'s corner branch): d_table sums each (sample,
    level, corner) contribution w * g into its vertex row in f32, in a
    fixed order (one stable sort of every level's rows, then
    ops/fixed_order.py::segment_sum_sorted); d_pos is the analytic
    position gradient, computed only when pos requires a gradient."""

    @staticmethod
    def forward(ctx, table, pos, config):
        ctx.config = config
        ctx.save_for_backward(table, pos)
        return _encode_corner(config, table, pos)

    @staticmethod
    def backward(ctx, g):
        table, pos = ctx.saved_tensors
        config = ctx.config
        L, F, T = config.n_levels, config.n_features_per_level, config.table_size
        N = pos.shape[0]
        C = 1 << config.n_dims
        gl = g.to(torch.promote_types(g.dtype, torch.float32)).reshape(N, L, F)
        want_pos = ctx.needs_input_grad[1]
        geo = _geometry_corner(config, pos, with_per_dim=want_pos)
        idx, w = geo[0], geo[1]
        d_table = d_pos = None
        if ctx.needs_input_grad[0]:
            keys = idx + torch.arange(L, device=pos.device)[None, :, None] * T  # (N, L, C)
            skeys, order = torch.sort(keys.reshape(-1), stable=True)
            row = order // C  # the (sample, level) of each sorted contribution
            contrib = w.reshape(-1)[order, None] * gl.reshape(N * L, F)[row]
            d = segment_sum_sorted(contrib, skeys, L * T)
            d_table = d.reshape(table.shape).to(table.dtype)
        if want_pos:
            cf = _corner_features(config, table, idx)
            d_pos = _position_gradient(config, cf, gl, w, geo[2]).to(pos.dtype)
        return d_table, d_pos, None


def hashgrid_encode(config: HashGridConfig, table: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """Encode from the f32 cell table (L, T, C, F), or the same flattened
    to (L, T*C*F), or from the corner-layout table (L, T, F) or (L, T*F);
    pos (N, D) in [0,1]^D -> (N, L*F) f32.  Differentiable in the table
    and in pos (HashGridEncode, HashGridEncodeCorner)."""
    if config.layout != "cell":
        return HashGridEncodeCorner.apply(table, pos, config)
    return HashGridEncode.apply(table, pos, config)


def hashgrid_stats(config: HashGridConfig, table, n_bins: int = 32) -> list[dict]:
    """Per-level statistics of the table's values (the reference's
    LevelStats): the level's resolution, mean, standard deviation, min,
    max, the share of values within 1e-7 of 0, and a histogram of n_bins
    bins with its edges, computed with numpy on the host as the reference
    computes them."""
    if isinstance(table, torch.Tensor):
        table = table.detach().cpu().numpy()
    t = np.asarray(table)
    stats = []
    for l in range(config.n_levels):
        x = t[l].reshape(-1)
        hist, edges = np.histogram(x, bins=n_bins)
        stats.append(dict(level=l, resolution=config.level_resolution(l),
                          mean=float(x.mean()), std=float(x.std()), min=float(x.min()),
                          max=float(x.max()), frac_zero=float((np.abs(x) < 1e-7).mean()),
                          histogram=hist.tolist(), bin_edges=edges.tolist()))
    return stats


def pack_table_bf16(config: HashGridConfig, table: torch.Tensor) -> torch.Tensor:
    """Render-only packing of the f32 cell table: (L, T, C, F) ->
    bfloat16 (L, T, C*F), half the gathered bytes."""
    _require_cell(config)
    return _rows3(config, table).to(torch.bfloat16)


def hashgrid_encode_bf16(config: HashGridConfig, packed: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Forward-only encode from a pack_table_bf16 table."""
    C, F = 1 << config.n_dims, config.n_features_per_level
    return _interpolate(
        config, pos,
        lambda l, idx: packed[l].index_select(0, idx).float().reshape(-1, C, F))


def pack_table_fp8(config: HashGridConfig, table: torch.Tensor):
    """Render-only quantization of the f32 cell table to e4m3 with one
    absmax scale per level: (L, T, C, F) -> (uint8 (L, T, C*F) e4m3 bytes,
    (L,) f32 scales)."""
    _require_cell(config)
    t = _rows3(config, table)
    scale = torch.clamp(t.abs().amax(dim=(1, 2)), min=1e-8) / 448.0
    t8 = (t / scale[:, None, None]).to(torch.float8_e4m3fn)
    return t8.view(torch.uint8), scale


def hashgrid_encode_fp8(config: HashGridConfig, table: torch.Tensor,
                        scale: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Forward-only encode from the e4m3 render table.

    table: uint8 (L, T, C*F) e4m3 bytes; scale: (Lq,) f32 per-level-group
    dequant scale, Lq dividing L (quant group q covers levels
    [q*L/Lq, (q+1)*L/Lq)); pos: (N, 3) in [0,1]^3.  -> (N, L*F) f32."""
    L, F = config.n_levels, config.n_features_per_level
    C = 1 << config.n_dims
    table = table.reshape(L, config.table_size, C * F)
    if scale.shape[0] != L:
        if L % scale.shape[0]:
            raise ValueError(f"{scale.shape[0]} scale groups do not divide {L} levels")
        scale = scale.repeat_interleave(L // scale.shape[0])

    def level_rows(l, idx):
        rows = table[l].index_select(0, idx)  # (N, C*F) uint8
        return rows.view(torch.float8_e4m3fn).float().reshape(-1, C, F) * scale[l]

    return _interpolate(config, pos, level_rows)
