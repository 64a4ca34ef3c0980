"""Single-branch network: input encoding -> MLP (port of the JAX package's
models/single_network.py), the network of the image, SDF and volume modes.

`params` is a dict {"grid": cell table (L, T, 2^D, F) when the encoding is
a hash grid, "takikawa": (n_vertices, 8) octree features when it is the
Takikawa encoding, "mlp": [W, ...]}; `pack_render_params` swaps the f32
table for the bf16 render table, forward only.  The Takikawa encoding reads
the octree's lookup tables, which the SDF engine builds from its mesh and
passes as `tables`; its config's final depth and vertex count are filled
in then (reference testbed.cu:4147-4162)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sienerf_torch.ops.encodings import (
    composite_encode,
    composite_specs_from_config,
    encoding_output_dim,
    frequency_encode,
    oneblob_encode,
    trianglewave_encode,
)
from sienerf_torch.ops.hashgrid import (
    HashGridConfig,
    hashgrid_encode,
    hashgrid_encode_bf16,
    init_hashgrid_params,
    pack_table_bf16,
)
from sienerf_torch.ops.mlp import MLPConfig, init_mlp_params, mlp_apply
from sienerf_torch.ops.takikawa import TakikawaConfig, init_takikawa_params, takikawa_encode

_GRID_OTYPES = ("hashgrid", "densegrid", "grid", "tiledgrid")


@dataclass(frozen=True)
class SingleNetworkConfig:
    n_input_dims: int
    n_output_dims: int
    encoding_otype: str
    grid: HashGridConfig | None
    encoding_params: dict
    composite_specs: tuple
    mlp: MLPConfig
    takikawa: TakikawaConfig | None = None
    takikawa_n_vertices: int = 0

    @staticmethod
    def from_network_config(cfg: dict, n_input_dims: int, n_output_dims: int,
                            aabb_scale: float = 1.0) -> "SingleNetworkConfig":
        enc = cfg.get("encoding", {"otype": "Identity"})
        otype = enc.get("otype", "Identity")
        grid = None
        composite_specs = ()
        takikawa = None
        if otype.lower() == "takikawa":
            takikawa = TakikawaConfig.from_network_config(enc)
            enc_out = takikawa.n_output_dims
        elif otype.lower() in _GRID_OTYPES:
            grid = HashGridConfig.from_network_config(enc, n_dims=n_input_dims,
                                                      aabb_scale=aabb_scale)
            enc_out = grid.n_output_dims
        elif otype.lower() == "composite":
            composite_specs = tuple(composite_specs_from_config(enc))
            enc_out, off = 0, 0
            for s in composite_specs:
                nd = s.n_dims_to_encode if s.n_dims_to_encode is not None \
                    else n_input_dims - off
                off += nd
                enc_out += encoding_output_dim(s.otype, nd, s.params)
        else:
            enc_out = encoding_output_dim(otype, n_input_dims, enc)
        mlp = MLPConfig.from_network_config(cfg.get("network", {}), enc_out, n_output_dims)
        return SingleNetworkConfig(n_input_dims=n_input_dims, n_output_dims=n_output_dims,
                                   encoding_otype=otype, grid=grid, encoding_params=dict(enc),
                                   composite_specs=composite_specs, mlp=mlp, takikawa=takikawa)


def init_single_network(config: SingleNetworkConfig, generator: torch.Generator,
                        device=None) -> dict:
    """He-uniform MLP weights; a hash grid's table or the octree features
    uniform in [-1e-4, 1e-4]."""
    params = {"mlp": init_mlp_params(config.mlp, generator, device)}
    if config.grid is not None:
        params["grid"] = init_hashgrid_params(config.grid, generator, device)
    if config.takikawa is not None:
        params["takikawa"] = init_takikawa_params(config.takikawa_n_vertices, generator,
                                                  device)
    return params


def encode_input(config: SingleNetworkConfig, params: dict, x: torch.Tensor,
                 tables: dict | None = None) -> torch.Tensor:
    """(N, n_input_dims) -> the encoded features (N, n_features) f32.  The
    Takikawa encoding needs the octree's `tables`."""
    if config.takikawa is not None:
        if tables is None:
            raise ValueError("the Takikawa encoding needs the octree tables (tables=...)")
        return takikawa_encode(config.takikawa, tables, params["takikawa"], x)
    if config.grid is not None:
        if "grid_bf16" in params:
            return hashgrid_encode_bf16(config.grid, params["grid_bf16"], x)
        return hashgrid_encode(config.grid, params["grid"], x)
    ot = config.encoding_otype.lower()
    p = config.encoding_params
    if ot == "composite":
        return composite_encode(x, list(config.composite_specs))
    if ot == "frequency":
        return frequency_encode(x, int(p.get("n_frequencies", 12)))
    if ot == "oneblob":
        return oneblob_encode(x, int(p.get("n_bins", 16)))
    if ot == "trianglewave":
        return trianglewave_encode(x, int(p.get("n_frequencies", 12)))
    if ot == "identity":
        return x
    raise ValueError(f"unsupported encoding {config.encoding_otype}")


def apply_single_network(config: SingleNetworkConfig, params: dict, x: torch.Tensor,
                         compute_dtype: torch.dtype = torch.bfloat16,
                         tables: dict | None = None) -> torch.Tensor:
    """x (N, n_input_dims) -> (N, n_output_dims) f32; the MLP in bf16 with
    f32 sums (the reference's precision) unless compute_dtype is f32."""
    return mlp_apply(config.mlp, params["mlp"], encode_input(config, params, x, tables),
                     compute_dtype=compute_dtype)


def pack_render_params(config: SingleNetworkConfig, params: dict) -> dict:
    """The params with the f32 cell table swapped for its bf16 render table
    (ops.hashgrid.pack_table_bf16).  Forward only: not for position
    gradients or training."""
    if config.grid is None or config.grid.layout != "cell" or "grid" not in params:
        return params
    p = dict(params)
    p["grid_bf16"] = pack_table_bf16(config.grid, p.pop("grid"))
    return p


def l2_mask(config: SingleNetworkConfig, params: dict) -> dict:
    """l2 regularisation on the MLP matrices, not the grid table or the
    octree features."""
    mask = {"mlp": [1.0 for _ in params["mlp"]]}
    if "grid" in params:
        mask["grid"] = 0.0
    if "takikawa" in params:
        mask["takikawa"] = 0.0
    return mask
