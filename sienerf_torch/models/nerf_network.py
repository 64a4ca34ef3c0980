"""NerfNetwork configuration, initialisation and forward (port of the JAX
package's models/nerf_network.py).

Topology: pos -> hash grid -> density MLP -> 16 geo features (density is
channel 0); [SH(dir), extra dims, geo features] -> rgb MLP -> 3.  Output
activations are applied outside the MLPs.  The position encoding is a 3-D
grid (f32 cell table, or its bf16 / fp8 render packing), the triplane
(configs/nerf/tensor.json: three 2-D hash grids over the coordinate pairs
(x, y), (y, z), (z, x), their features concatenated; params["grid"] is
then a list of three f32 cell tables) or one of the analytic encodings.
Extra dims (per-image latent codes, light directions) condition the
colour MLP between the SH block and the geo features.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sienerf_torch.common import NerfActivation
from sienerf_torch.ops.encodings import (
    CompositeSpec,
    composite_encode,
    encoding_output_dim,
    sh_encode,
)
from sienerf_torch.ops.hashgrid import (
    HashGridConfig,
    hashgrid_encode,
    hashgrid_encode_bf16,
    hashgrid_encode_fp8,
    init_hashgrid_params,
)
from sienerf_torch.ops.mlp import MLPConfig, init_mlp_params, mlp_apply

N_GEO_FEATURES = 16

_GRID_OTYPES = ("hashgrid", "densegrid", "tiledgrid", "grid")
_ANALYTIC_OTYPES = ("frequency", "oneblob", "trianglewave", "identity")
# the triplane's coordinate pairs, one 2-D grid each (the reference's
# configs/nerf/tensor.json composites three 2-D hash grids)
_TRIPLANE_DIMS = ((0, 1), (1, 2), (2, 0))


@dataclass(frozen=True)
class NerfNetworkConfig:
    # the 3-D grid config, a tuple of three 2-D grid configs for the
    # triplane, or None for an analytic position encoding
    grid: HashGridConfig | tuple | None
    density_mlp: MLPConfig
    rgb_mlp: MLPConfig
    sh_degree: int = 4
    n_extra_dims: int = 0
    rgb_activation: NerfActivation = NerfActivation.LOGISTIC
    density_activation: NerfActivation = NerfActivation.EXPONENTIAL
    pos_otype: str = "grid"  # "grid", "triplane" or an analytic otype
    pos_opts: tuple = ()  # analytic-encoding params as sorted (key, value) pairs

    @staticmethod
    def from_network_config(cfg: dict, aabb_scale: float = 1.0,
                            n_extra_dims: int = 0,
                            hdr: bool = False) -> "NerfNetworkConfig":
        enc = cfg.get("encoding", {})
        ot = enc.get("otype", "HashGrid").lower()
        pos_opts = ()
        if ot in _GRID_OTYPES:
            pos_otype = "grid"
            grid = HashGridConfig.from_network_config(enc, n_dims=3, aabb_scale=aabb_scale)
            n_enc = grid.n_output_dims
        elif ot == "composite":
            nested = enc.get("nested", [])
            if not nested or not all(e.get("otype", "").lower() in _GRID_OTYPES
                                     for e in nested):
                raise ValueError("NeRF composite pos encoding supports only nested grids")
            pos_otype = "triplane"
            grid = tuple(HashGridConfig.from_network_config(e, n_dims=2, aabb_scale=aabb_scale)
                         for e in nested[:3])
            n_enc = sum(g.n_output_dims for g in grid)
        elif ot in _ANALYTIC_OTYPES:
            pos_otype = ot
            grid = None
            opts = {k: v for k, v in enc.items() if k != "otype"}
            n_enc = encoding_output_dim(ot, 3, opts)
            pos_opts = tuple(sorted(opts.items()))
        else:
            raise NotImplementedError(
                f"NeRF pos encoding {enc.get('otype')} is not ported yet")
        sh_degree = 4
        for entry in cfg.get("dir_encoding", {}).get("nested", []):
            if entry.get("otype", "").lower() == "sphericalharmonics":
                sh_degree = int(entry.get("degree", 4))
        density_mlp = MLPConfig.from_network_config(
            cfg.get("network", {}), n_enc, N_GEO_FEATURES)
        rgb_in = sh_degree ** 2 + n_extra_dims + N_GEO_FEATURES
        rgb_mlp = MLPConfig.from_network_config(cfg.get("rgb_network", {}), rgb_in, 3)
        return NerfNetworkConfig(
            grid=grid,
            density_mlp=density_mlp,
            rgb_mlp=rgb_mlp,
            sh_degree=sh_degree,
            n_extra_dims=n_extra_dims,
            rgb_activation=NerfActivation.EXPONENTIAL if hdr else NerfActivation.LOGISTIC,
            pos_otype=pos_otype,
            pos_opts=pos_opts,
        )


def init_nerf_network(config: NerfNetworkConfig, generator: torch.Generator,
                      device=None) -> dict:
    """Fresh params: the hash table (grid encodings) and both MLPs."""
    params = {
        "density_mlp": init_mlp_params(config.density_mlp, generator, device),
        "rgb_mlp": init_mlp_params(config.rgb_mlp, generator, device),
    }
    if config.pos_otype == "grid":
        params["grid"] = init_hashgrid_params(config.grid, generator, device)
    elif config.pos_otype == "triplane":
        params["grid"] = [init_hashgrid_params(g, generator, device) for g in config.grid]
    return params


def nerf_l2_mask(params: dict) -> dict:
    """1.0 on the MLP matrices, which take l2 regularisation, 0.0 on the
    hash table (each of the triplane's tables) and the learners' leaves."""
    mask = {
        "density_mlp": [1.0 for _ in params["density_mlp"]],
        "rgb_mlp": [1.0 for _ in params["rgb_mlp"]],
    }
    if "grid" in params:
        mask["grid"] = [0.0 for _ in params["grid"]] \
            if isinstance(params["grid"], (list, tuple)) else 0.0
    for extra in ("cam", "focal", "exposure", "distortion", "envmap", "extra_dims"):
        if extra in params:
            mask[extra] = 0.0
    return mask


def _encode_pos(config: NerfNetworkConfig, params: dict,
                pos_unit: torch.Tensor) -> torch.Tensor:
    """Encode positions warped to [0,1]^3.  The grid path reads a packed
    render table when the params carry one (fp8, then bf16), else the f32
    table; the triplane reads its three f32 tables."""
    if config.pos_otype == "grid":
        if "grid_fp8" in params:
            return hashgrid_encode_fp8(config.grid, params["grid_fp8"],
                                       params["grid_fp8_scale"], pos_unit)
        if "grid_bf16" in params:
            return hashgrid_encode_bf16(config.grid, params["grid_bf16"], pos_unit)
        return hashgrid_encode(config.grid, params["grid"], pos_unit)
    if config.pos_otype == "triplane":
        return torch.cat([hashgrid_encode(g, t, pos_unit[..., list(dims)])
                          for g, t, dims in zip(config.grid, params["grid"], _TRIPLANE_DIMS)],
                         dim=-1)
    spec = CompositeSpec(otype=config.pos_otype, params=dict(config.pos_opts))
    return composite_encode(pos_unit, [spec])


def density_raw(config: NerfNetworkConfig, params: dict,
                pos_unit: torch.Tensor) -> torch.Tensor:
    """Raw (pre-activation) density for positions warped to [0,1]^3."""
    feats = _encode_pos(config, params, pos_unit)
    return mlp_apply(config.density_mlp, params["density_mlp"], feats)[..., 0]


def nerf_apply(config: NerfNetworkConfig, params: dict, pos_unit: torch.Tensor,
               dir_unit_cube: torch.Tensor, extra: torch.Tensor | None = None):
    """Full forward: (N, 3) warped positions and (N, 3) directions warped to
    [0,1]^3 -> (rgb_raw (N, 3), density_raw (N,)), both pre-activation.
    `extra` (N, n_extra_dims) conditions the colour MLP (zeros when the
    network has extra dims and none are given)."""
    feats = _encode_pos(config, params, pos_unit)
    geo = mlp_apply(config.density_mlp, params["density_mlp"], feats)
    parts = [sh_encode(dir_unit_cube, config.sh_degree)]
    if config.n_extra_dims:
        if extra is None:
            extra = torch.zeros(pos_unit.shape[:-1] + (config.n_extra_dims,),
                                dtype=torch.float32, device=pos_unit.device)
        parts.append(extra)
    parts.append(geo)
    rgb = mlp_apply(config.rgb_mlp, params["rgb_mlp"], torch.cat(parts, dim=-1))
    return rgb, geo[..., 0]


def apply_rgb_activation(raw: torch.Tensor, act: NerfActivation) -> torch.Tensor:
    if act == NerfActivation.LOGISTIC:
        return torch.sigmoid(raw)
    if act == NerfActivation.EXPONENTIAL:
        return torch.exp(raw.clamp(-10.0, 10.0))
    if act == NerfActivation.RELU:
        return torch.relu(raw)
    return raw


def apply_density_activation(raw: torch.Tensor, act: NerfActivation) -> torch.Tensor:
    if act == NerfActivation.EXPONENTIAL:
        return torch.exp(raw.clamp(-15.0, 15.0))
    if act == NerfActivation.RELU:
        return torch.relu(raw)
    if act == NerfActivation.LOGISTIC:
        return torch.sigmoid(raw)
    return raw
