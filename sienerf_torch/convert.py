"""Carry weights, training states and bakes across from the JAX package's
numpy form.

The JAX package packs fp8 and bf16 table rows as f32 bitcasts, int16 and
int8 bake rows as int32 lanes and bit sidecars as uint32 for its TPU
gathers; the port keeps the bytes in their own types.  These helpers take
plain numpy arrays (no JAX import) so the same field can feed both
packages.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.float16:
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(np_params: dict,
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """JAX render params as numpy -> the port's params.

    `grid_fp8` may be the JAX loader's f32-bitcast rows (L, T, C*F/4) or the
    e4m3 bytes as uint8 (L, T, C*F); either becomes uint8 (L, T, C*F).
    `grid_bf16` is pack_table_bf16's f32-bitcast rows (L, T, C*F/2, the
    first value of a pair in the low half) and becomes bfloat16
    (L, T, C*F).  The f32 `grid`, (L, T, C, F) or flat (L, T*C*F), passes
    through.  fp16 leaves widen to f32; MLP weight lists stay lists."""
    out = {}
    for k, v in np_params.items():
        if k == "grid_fp8":
            a = np.ascontiguousarray(np.asarray(v))
            if a.ndim != 3:
                raise ValueError(f"grid_fp8 must be (L, T, row), got {a.shape}")
            u8 = a.view(np.uint8).reshape(a.shape[0], a.shape[1], -1)
            out[k] = torch.from_numpy(np.array(u8)).to(device)
        elif k == "grid_bf16":
            a = np.ascontiguousarray(np.asarray(v))
            if a.ndim != 3 or a.dtype != np.float32:
                raise ValueError(f"grid_bf16 must be f32 (L, T, row/2), got "
                                 f"{a.dtype} {a.shape}")
            i16 = a.view("<i2").reshape(a.shape[0], a.shape[1], -1)
            out[k] = torch.from_numpy(np.array(i16)).view(torch.bfloat16).to(device)
        elif isinstance(v, (list, tuple)):
            out[k] = [_leaf(w, device) for w in v]
        else:
            out[k] = _leaf(v, device)
    return out


def single_network_from_jax(np_params: dict, grid_config=None,
                            device: str | torch.device = "cuda") -> dict:
    """A JAX single network's params as numpy -> the port's.  The image
    engine keeps its table flat, (L, T*C*F) (a TPU tiling workaround);
    with the network's HashGridConfig `grid_config` the table (flat or
    not) becomes the port's (L, T, 2^D, F) cell table, or (L, T, F) for
    the corner layout.  A Takikawa network's (n_vertices, 8) octree
    features ("takikawa") pass as they are."""
    out = params_from_jax(np_params, device)
    if grid_config is not None and "grid" in out:
        g = grid_config
        corners = (1 << g.n_dims,) if g.layout == "cell" else ()
        out["grid"] = out["grid"].reshape(g.n_levels, g.table_size, *corners,
                                          g.n_features_per_level).contiguous()
    return out


def baked_grid_from_jax(grid: dict,
                        device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """A JAX bake as numpy -> the port's.  Row tables ("rows": vertex rows,
    or cell rows of a trilinear bake; "brows": brick rows) are int32 lanes
    holding int16 pairs or int8 quads (little-endian, as the JAX bitcast
    lays them out) and become int16 / int8 rows of their values; the
    uint32 bit and byte sidecars keep their bits as int32; the scale stays
    f32."""
    out = {}
    for k, v in grid.items():
        a = np.ascontiguousarray(np.asarray(v))
        if k in ("rows", "brows"):
            if a.dtype != np.int32:
                raise ValueError(f"{k}: expected int32-packed rows, got {a.dtype}")
            n_vert = 16 if k == "brows" else (1 if a.shape[1] in (4, 8) else 8)
            width = a.shape[1] * 4 // (n_vert * 16)  # bytes a value
            a = a.view("<i2" if width == 2 else np.int8).reshape(a.shape[0], -1)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        elif k == "scale":
            a = a.astype(np.float32)
        out[k] = torch.from_numpy(np.array(a)).to(device)
    return out


def train_state_from_jax(np_state: dict,
                         device: str | torch.device = "cuda") -> dict:
    """A JAX NerfEngine training state as numpy -> the port's training
    state: params, optimizer m / v / ema / step, occupancy density /
    bitfield / mean_density / n_updates, step and the error map.  Steps
    and update counts become Python ints, as the port keeps them."""
    opt = np_state["opt"]
    state = {
        "params": params_from_jax(np_state["params"], device),
        "opt": {"m": params_from_jax(opt["m"], device),
                "v": params_from_jax(opt["v"], device),
                "step": int(np.asarray(opt["step"]))},
        "occ": {"density": _leaf(np_state["occ"]["density"], device),
                "bitfield": _leaf(np_state["occ"]["bitfield"], device).bool(),
                "mean_density": _leaf(np.float32(np_state["occ"]["mean_density"]), device),
                "n_updates": int(np.asarray(np_state["occ"]["n_updates"]))},
        "step": int(np.asarray(np_state["step"])),
    }
    if "ema" in opt:
        state["opt"]["ema"] = params_from_jax(opt["ema"], device)
    if "emap" in np_state:
        state["emap"] = {"error": _leaf(np_state["emap"]["error"], device),
                         "decay": float(np.float32(np_state["emap"]["decay"]))}
    return state


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tree_to_numpy(tree):
    """Tensors (and lists of them) of a params tree -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    return _np(tree)


def train_state_to_jax(state: dict) -> dict:
    """The inverse of train_state_from_jax: the port's training state ->
    numpy arrays in the JAX package's layout and types (int32 steps and
    update counts, bool bitfield, f32 scalars), as its save_snapshot
    writes them."""
    opt = state["opt"]
    out = {
        "params": tree_to_numpy(state["params"]),
        "opt": {"m": tree_to_numpy(opt["m"]), "v": tree_to_numpy(opt["v"]),
                "step": np.asarray(opt["step"], np.int32)},
        "occ": {"density": _np(state["occ"]["density"]).astype(np.float32),
                "bitfield": _np(state["occ"]["bitfield"]).astype(bool),
                "mean_density": np.asarray(_np(state["occ"]["mean_density"]), np.float32),
                "n_updates": np.asarray(state["occ"]["n_updates"], np.int32)},
        "step": np.asarray(state["step"], np.int32),
    }
    if "ema" in opt:
        out["opt"]["ema"] = tree_to_numpy(opt["ema"])
    if "emap" in state:
        out["emap"] = {"error": _np(state["emap"]["error"]),
                       "decay": np.asarray(state["emap"]["decay"], np.float32)}
    return out
