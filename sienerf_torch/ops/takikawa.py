"""Takikawa (NGLOD) octree feature encoding (port of the JAX package's
ops/takikawa.py).

Behavioral spec: reference takikawa_encoding.cuh:28-130: at every octree
level d >= starting_level the query position's cell is looked up (one
`searchsorted` into the level's sorted cell codes: a found cell implies its
whole ancestor chain, so levels are independent lookups), and its 8
corner-vertex features are interpolated trilinearly with the position
local to the cell (optionally smoothstep-warped).  Levels are concatenated,
or summed with `sum_instead_of_concat`.  Features init U(-1e-4, 1e-4);
n_params = 8 * n_vertices; output dims = 8 * (depth - starting_level).

The gradients: the features' is a scatter of w * g into the (n_vertices, 8)
table, summed in a fixed order (ops/fixed_order.py: all levels'
contributions sorted by vertex once, each vertex's summed pairwise) so
that one seed gives one result on the card; the position's flows through
the lerp weights (analytic SDF normals), by autograd.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sienerf_torch.ops.fixed_order import segment_sum_sorted

N_FEATURES_PER_LEVEL = 8  # takikawa_encoding.cuh:272 template default


@dataclass(frozen=True)
class TakikawaConfig:
    depth: int  # octree depth (config n_levels)
    starting_level: int = 4
    sum_instead_of_concat: bool = False
    interpolation: str = "linear"  # or "smoothstep"

    @property
    def n_levels_out(self) -> int:
        return self.depth - self.starting_level

    @property
    def n_output_dims(self) -> int:
        if self.sum_instead_of_concat:
            return N_FEATURES_PER_LEVEL
        return N_FEATURES_PER_LEVEL * self.n_levels_out

    @staticmethod
    def from_network_config(enc: dict) -> "TakikawaConfig":
        return TakikawaConfig(
            depth=int(enc.get("n_levels", 8)),
            starting_level=int(enc.get("starting_level", 4)),
            sum_instead_of_concat=bool(enc.get("sum_instead_of_concat", False)),
            interpolation=str(enc.get("interpolation", "linear")).lower(),
        )


def init_takikawa_params(n_vertices: int, generator: torch.Generator,
                         device=None) -> torch.Tensor:
    """(n_vertices, 8) f32 features, uniform in [-1e-4, 1e-4]."""
    return torch.empty((n_vertices, N_FEATURES_PER_LEVEL), dtype=torch.float32,
                       device=device).uniform_(-1e-4, 1e-4, generator=generator)


# corner c's offset along dim dd is bit dd of c (the octree's child order)
_CORNER_BITS = [[(c >> dd) & 1 for dd in range(3)] for c in range(8)]


class _CornerLerp(torch.autograd.Function):
    """sum over corners c of w[:, l, c] * features[vids[:, l, c]] for every
    level l -> (N, L, 8); the features' gradient in a fixed order."""

    @staticmethod
    def forward(ctx, features, vids, w):
        ctx.save_for_backward(features, vids, w)
        cf = features.index_select(0, vids.reshape(-1)).reshape(*vids.shape, -1)
        return (w[..., None] * cf).sum(dim=2)

    @staticmethod
    def backward(ctx, g):
        features, vids, w = ctx.saved_tensors
        d_feat = d_w = None
        if ctx.needs_input_grad[0]:
            keys, order = torch.sort(vids.reshape(-1), stable=True)
            contrib = (w[..., None] * g[:, :, None, :]).reshape(-1, features.shape[1])
            d_feat = segment_sum_sorted(contrib[order], keys, features.shape[0])
        if ctx.needs_input_grad[2]:
            cf = features.index_select(0, vids.reshape(-1)).reshape(*vids.shape, -1)
            d_w = (cf * g[:, :, None, :]).sum(dim=-1)
        return d_feat, None, d_w


def takikawa_encode(config: TakikawaConfig, tables: dict, features: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
    """pos (N, 3) in [0,1]^3 -> (N, n_output_dims).  `tables` holds the
    per-level {"codes_<d>": sorted int32, "verts_<d>": (n_d, 8) int32} of
    geom/octree.py::octree_device_tables.  Differentiable in the features
    and in pos."""
    N = pos.shape[0]
    bits = torch.tensor(_CORNER_BITS, dtype=torch.bool, device=pos.device)
    vids, weights, found = [], [], []
    for d in range(config.starting_level, config.depth):
        s = 1 << d
        x = pos * s
        cell_f = torch.floor(torch.clamp(x, 0.0, s - 1e-4)).detach()
        local = x - cell_f
        cell = cell_f.to(torch.int32)
        code = (cell[:, 0] * s + cell[:, 1]) * s + cell[:, 2]
        codes_d, verts_d = tables[f"codes_{d}"], tables[f"verts_{d}"]
        n_d = codes_d.shape[0]
        if n_d:
            i = torch.clamp(torch.searchsorted(codes_d, code), 0, n_d - 1)
            found.append(codes_d[i] == code)
            vids.append(verts_d[i].long())
        else:
            found.append(torch.zeros(N, dtype=torch.bool, device=pos.device))
            vids.append(torch.zeros((N, 8), dtype=torch.long, device=pos.device))
        wl = local * local * (3.0 - 2.0 * local) if config.interpolation == "smoothstep" \
            else local
        # corner c's weight: the product over dims of (w if bit set else 1 - w)
        per = torch.where(bits[None], wl[:, None, :], 1.0 - wl[:, None, :])  # (N, 8, 3)
        weights.append(per[..., 0] * per[..., 1] * per[..., 2])
    lvl = _CornerLerp.apply(features, torch.stack(vids, dim=1), torch.stack(weights, dim=1))
    lvl = torch.where(torch.stack(found, dim=1)[..., None], lvl, 0.0)  # (N, L, 8)
    if config.sum_instead_of_concat:  # level by level, as the reference adds them
        out = torch.zeros((N, N_FEATURES_PER_LEVEL), dtype=lvl.dtype, device=pos.device)
        for li in range(lvl.shape[1]):
            out = out + lvl[:, li]
        return out
    return lvl.reshape(N, -1)
