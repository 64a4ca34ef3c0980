"""Snapshot save and load (port of the JAX package's io/snapshot.py).

A snapshot is zlib-compressed msgpack holding {"version", "state", "config",
"meta"}; arrays are {"__ndarray__", "dtype", "shape", "data"} leaves keyed
by bytes, and the occupancy density is stored as fp16.  The codec is the
package's own pure-Python msgpack (io/msgpack_lite.py), so no msgpack
package is needed; the files it writes load in the JAX package's
load_snapshot, and the JAX package's files load here.
"""

from __future__ import annotations

import math
import zlib
from pathlib import Path

import numpy as np
import torch

from sienerf_torch.io import msgpack_lite
from sienerf_torch.ops.hashgrid import HashGridConfig
from sienerf_torch.ops.occupancy import n_cascades_for_aabb_scale


def _unpack_tree(tree):
    if isinstance(tree, dict):
        # the writer keys array leaves with bytes (msgpack bin) or str
        tree = {(k.decode() if isinstance(k, bytes) else k): v for k, v in tree.items()}
        if "__ndarray__" in tree:
            arr = np.frombuffer(tree["data"], dtype=np.dtype(tree["dtype"]))
            return arr.reshape(tree["shape"])
        return {k: _unpack_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unpack_tree(v) for v in tree]
    return tree


SNAPSHOT_VERSION = 1


def _pack_tree(tree):
    if isinstance(tree, dict):
        return {k: _pack_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_pack_tree(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return {b"__ndarray__": True, b"dtype": tree.dtype.str,
                b"shape": list(tree.shape), b"data": tree.tobytes()}
    return tree


def save_snapshot(path: str | Path, state: dict, config: dict | None = None,
                  meta: dict | None = None, level: int = 6) -> None:
    """Write a state tree of numpy leaves (convert.train_state_to_jax gives
    the training state in that form), zlib-compressed at `level`; the
    occupancy density is stored as fp16, as the reference stores it."""
    state = dict(state)
    if "density" in state.get("occ", {}):
        state["occ"] = dict(state["occ"], density=np.asarray(state["occ"]["density"],
                                                             np.float16))
    payload = {"version": SNAPSHOT_VERSION, "state": _pack_tree(state),
               "config": config or {}, "meta": meta or {}}
    Path(path).write_bytes(zlib.compress(msgpack_lite.pack(payload), level))


def load_snapshot(path: str | Path) -> dict:
    """-> {"version", "state", "config", "meta"} with numpy leaves."""
    raw = Path(path).read_bytes()
    try:
        raw = zlib.decompress(raw)
    except zlib.error:
        pass  # uncompressed snapshot
    payload = msgpack_lite.unpack(raw)
    payload["state"] = _unpack_tree(payload["state"])
    occ = payload["state"].get("occ", {})
    if "density" in occ:
        occ["density"] = np.asarray(occ["density"], np.float32)
    return payload


def check_render_snapshot(meta: dict, grid_scale_levels: int, n_cascades: int,
                          network_config: dict, aabb_scale: float) -> None:
    """Raise when a render-only fp8 snapshot does not fit the network config
    it is about to be rendered with.  An 8x4 table read as 16x2 renders fog
    without any error, so the hash-grid shape is checked against
    meta["grid_shape"]; the bitfield's cascade count must be the one the
    aabb_scale implies."""
    L, T, C, F = meta["grid_shape"]
    enc = network_config.get("encoding", {})
    grid = HashGridConfig.from_network_config(enc, aabb_scale=aabb_scale)
    want = (grid.n_levels, grid.table_size, 1 << grid.n_dims,
            grid.n_features_per_level)
    if want != (L, T, C, F):
        raise ValueError(
            f"network config hash grid (L, T, C, F) = {want} disagrees with "
            f"the snapshot's grid_shape {(L, T, C, F)}")
    if L % grid_scale_levels:
        raise ValueError(
            f"{grid_scale_levels} fp8 scale groups do not divide {L} levels")
    if n_cascades != n_cascades_for_aabb_scale(aabb_scale):
        raise ValueError(
            f"bitfield has {n_cascades} cascades but aabb_scale {aabb_scale} "
            f"implies {n_cascades_for_aabb_scale(aabb_scale)}")


def load_render_snapshot(path: str | Path, network_config: dict | None = None,
                         aabb_scale: float | None = None,
                         device: str | torch.device = "cuda"):
    """Load a render-only snapshot -> (params, bitfield, meta) on `device`.

    The fp8 hash table stays as its e4m3 bytes, `uint8 (L, T, C*F)`;
    consumers decode with `.view(torch.float8_e4m3fn)`.  fp16 leaves widen
    to f32.  With `network_config` and `aabb_scale` given, the snapshot is
    checked against them (check_render_snapshot)."""
    return render_snapshot_from_payload(load_snapshot(path), network_config,
                                        aabb_scale, device)


def render_snapshot_from_payload(payload: dict, network_config: dict | None = None,
                                 aabb_scale: float | None = None,
                                 device: str | torch.device = "cuda"):
    """load_render_snapshot on an already decoded load_snapshot payload."""
    rs = payload["state"]
    meta = dict(payload["meta"])
    params = {}
    for k, v in rs["params"].items():
        if isinstance(v, list):
            params[k] = [_to_tensor(w, device) for w in v]
        else:
            params[k] = _to_tensor(v, device)
    if meta.get("kind") == "render_only_fp8":
        L, T, C, F = meta["grid_shape"]
        params["grid_fp8"] = params["grid_fp8"].reshape(L, T, C * F)
    bitfield = _to_tensor(rs["occ"]["bitfield"], device)
    meta["step"] = int(np.asarray(rs["step"]))
    if network_config is not None:
        n_casc = int(bitfield.shape[0])
        if aabb_scale is None:
            aabb_scale = float(2 ** (n_casc - 1))
        check_render_snapshot(meta, int(params["grid_fp8_scale"].shape[0]),
                              n_casc, network_config, aabb_scale)
    return params, bitfield, meta


def _to_tensor(x: np.ndarray, device) -> torch.Tensor:
    # decoded leaves are read-only views of the msgpack buffer: copy once
    x = np.array(x, np.float32 if x.dtype == np.float16 else x.dtype)
    return torch.from_numpy(x).to(device)


def grid_config_for_snapshot(base_config: dict, meta: dict) -> dict:
    """The base network config with its hash-grid encoding sized from the
    snapshot's meta["grid_shape"] (levels, log2 table size, features)."""
    L, T, _, F = meta["grid_shape"]
    cfg = dict(base_config)
    cfg["encoding"] = dict(cfg.get("encoding", {}), n_levels=int(L),
                           n_features_per_level=int(F),
                           log2_hashmap_size=int(round(math.log2(T))))
    return cfg
