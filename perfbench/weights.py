"""Seeded weights of a NeRF network, made by the benchmark on the device.

A frozen copy of the program's initialisation scheme, in the shapes of its
parameter tree: from one torch.Generator seeded with the run's seed, the
density MLP's and then the colour MLP's bias-free (d_in, d_out) f32
matrices, He-uniform in [-sqrt(6/d_in), sqrt(6/d_in)], then the cell-layout
hash table (L, T, 8, F) f32, uniform in [-1e-4, 1e-4] (tcnn's initial
features).  The same values go to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

N_GEO = 16  # the density MLP's outputs: density and 15 geometry features


def mlp_dims(n_in: int, n_out: int, width: int, hidden: int) -> list[tuple[int, int]]:
    dims, d = [], n_in
    for _ in range(hidden):
        dims.append((d, width))
        d = width
    return dims + [(d, n_out)]


def network_dims(net: dict) -> dict:
    """A tcnn NeRF network config -> the matrix shapes of both MLPs and the
    table's (L, T, 8, F)."""
    enc, dn, rn = net["encoding"], net["network"], net["rgb_network"]
    L, F_ = int(enc["n_levels"]), int(enc["n_features_per_level"])
    return {
        "density_mlp": mlp_dims(L * F_, N_GEO, int(dn["n_neurons"]), int(dn["n_hidden_layers"])),
        "rgb_mlp": mlp_dims(16 + N_GEO, 3, int(rn["n_neurons"]), int(rn["n_hidden_layers"])),
        "grid": (L, 1 << int(enc["log2_hashmap_size"]), 8, F_),
    }


def seeded_params(net: dict, seed: int, device) -> dict:
    """{"density_mlp": [...], "rgb_mlp": [...], "grid": (L, T, 8, F)} drawn
    from `seed` in a few large calls on `device`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dims = network_dims(net)
    out = {}
    for name in ("density_mlp", "rgb_mlp"):
        out[name] = []
        for d_in, d_out in dims[name]:
            bound = math.sqrt(6.0 / d_in)
            out[name].append(torch.empty((d_in, d_out), dtype=torch.float32, device=device)
                             .uniform_(-bound, bound, generator=gen))
    out["grid"] = torch.empty(dims["grid"], dtype=torch.float32, device=device) \
        .uniform_(-1e-4, 1e-4, generator=gen)
    return out
