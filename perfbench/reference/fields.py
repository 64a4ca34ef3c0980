"""A configuration's NeRF field as the plain reference reads it: the hash
encoding of its table (a snapshot's e4m3 table with one scale a level, or
seeded f32 weights over a snapshot's occupancy), the density and colour
MLP weights, and the occupancy bitfield.  It imports nothing of the
program."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import spec
from perfbench.reference import field as ref_field
from perfbench.reference.snapshot import read_render_snapshot
from perfbench.weights import seeded_params

NETWORK_KEYS = ("loss", "optimizer", "encoding", "network", "dir_encoding", "rgb_network")


def field_parts(config: dict, seed: int, device) -> dict:
    """-> {"encode": unit positions (N, 3) -> features, "density_w",
    "rgb_w", "bitfield": bool (K, G, G, G)} on `device`."""
    net = {k: config[k] for k in NETWORK_KEYS}
    grid = ref_field.grid_spec(net["encoding"], config["aabb_scale"])
    w = config["weights"]
    if w["kind"] == "snapshot":
        snap = read_render_snapshot(spec.ROOT / w["file"])
        table = torch.from_numpy(snap["grid_fp8"].copy()).to(device)
        rows_of = ref_field.fp8_rows(table, torch.from_numpy(snap["grid_scale"]).to(device),
                                     grid["F"])
        density_w = [torch.from_numpy(x).to(device) for x in snap["density_mlp"]]
        rgb_w = [torch.from_numpy(x).to(device) for x in snap["rgb_mlp"]]
        bitfield = snap["bitfield"]
    else:
        p = seeded_params(net, seed, device)
        rows_of = ref_field.f32_rows(p["grid"], grid["F"])
        density_w, rgb_w = p["density_mlp"], p["rgb_mlp"]
        bitfield = read_render_snapshot(spec.ROOT / w["occupancy"])["bitfield"]
    return {"encode": lambda u: ref_field.hash_encode(grid, rows_of, u),
            "density_w": density_w, "rgb_w": rgb_w,
            "bitfield": torch.from_numpy(np.array(bitfield)).to(device).bool()}
