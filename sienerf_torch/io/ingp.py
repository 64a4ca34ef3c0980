"""Reference `.ingp`/`.msgpack` snapshot import/export (port of the JAX
package's io/ingp.py; numpy, no device code).

Format (reference testbed.cu:5219-5283 `save_snapshot` / :5285-5495
`load_snapshot`): the whole network-config json serialized as msgpack
(nlohmann `json::to_msgpack`), zlib-compressed when the extension is
`.ingp` (zstr), with the trained state under a "snapshot" key:

  snapshot.version, .mode ("nerf"), .training_step, .loss
  snapshot.density_grid_size (128), .density_grid_binary (fp16 bin,
     cascades x 128^3, Morton-ordered within each cascade —
     cascaded_grid_idx_at nerf_device.cuh:316-332)
  snapshot.nerf.aabb_scale / .dataset / .rgb counters
  snapshot.aabb / camera fields
  + the tcnn Trainer payload: n_params, params_type ("__half"/"float"),
    params_binary (inference params)

tcnn parameter layout for the NerfNetwork composite
(nerf_network.h:356-371 `set_params_impl`):
  [density MLP | rgb MLP | hash grid | dir encoding (0 params)]
- MLP weights: per layer, [n_out x n_in] row-major half; layer dims use
  tcnn padding (input as given, hidden n_neurons, final output padded to
  16).  Our MLPs compute x @ W with W (n_in, n_out), so matrices transpose
  on the way through.
- Hash grid: level-major; level l holds `params_in_level` rows x
  n_features, feature-minor, where params_in_level = min(table_size,
  next_multiple(res_l^3, 8)); dense levels index by stride, hash levels by
  the xor-prime hash — identical to ops/hashgrid.py's "corner" layout, so
  import targets `layout="corner"` configs (exact); the default "cell"
  layout shares row hashing with tcnn corners, enabling an exact slot-0
  export, and a cell import that is exact on every level whose cells can
  be enumerated (corner_to_cell_table).
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

from sienerf_torch.io import msgpack_lite
from sienerf_torch.models.nerf_network import N_GEO_FEATURES
from sienerf_torch.ops.hashgrid import _PRIMES, HashGridConfig
from sienerf_torch.ops.mlp import MLPConfig, mlp_layer_dims

SNAPSHOT_FORMAT_VERSION = 1  # reference common.h SNAPSHOT_FORMAT_VERSION


def load_ingp(path: str | Path) -> dict:
    """Read a `.ingp`/`.msgpack` file into a python dict tree."""
    raw = Path(path).read_bytes()
    if raw[:1] == b"\x78":  # zlib header (zstr compression, testbed.cu:5277)
        raw = zlib.decompress(raw)
    return msgpack_lite.unpack(raw)


def save_ingp(path: str | Path, config: dict, compress: bool = True) -> None:
    data = msgpack_lite.pack(config)
    if str(path).endswith(".ingp") and compress:
        data = zlib.compress(data)
    Path(path).write_bytes(data)


# --- morton order (tcnn morton3D: x in the lowest interleaved bit) ---------


def _expand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64)
    v = (v * np.uint64(0x00010001)) & np.uint64(0xFF0000FF)
    v = (v * np.uint64(0x00000101)) & np.uint64(0x0F00F00F)
    v = (v * np.uint64(0x00000011)) & np.uint64(0xC30C30C3)
    v = (v * np.uint64(0x00000005)) & np.uint64(0x49249249)
    return v


def morton3d(x: np.ndarray, y: np.ndarray, z: np.ndarray) -> np.ndarray:
    return (_expand_bits(x) | (_expand_bits(y) << np.uint64(1)) | (_expand_bits(z) << np.uint64(2))).astype(np.int64)


def _morton_perm(g: int) -> np.ndarray:
    """perm[linear xyz index] = morton index, for one g^3 cascade."""
    xs, ys, zs = np.meshgrid(np.arange(g), np.arange(g), np.arange(g), indexing="ij")
    return morton3d(xs.reshape(-1), ys.reshape(-1), zs.reshape(-1))


def density_grid_from_morton(flat: np.ndarray, grid_size: int) -> np.ndarray:
    """(C*G^3,) Morton-ordered -> (C,G,G,G) linear [x][y][z]."""
    g = grid_size
    n = g * g * g
    c = flat.size // n
    perm = _morton_perm(g)
    out = flat.reshape(c, n)[:, perm]
    return out.reshape(c, g, g, g)


def density_grid_to_morton(grid: np.ndarray) -> np.ndarray:
    c, g = grid.shape[0], grid.shape[1]
    n = g * g * g
    perm = _morton_perm(g)
    out = np.empty((c, n), grid.dtype)
    out[:, perm] = grid.reshape(c, n)
    return out.reshape(-1)


def _corner_offsets(n_dims: int) -> np.ndarray:
    """(2^D, D) binary corner offsets: bit d of corner c is its offset
    along dim d."""
    n = 1 << n_dims
    return np.array([[(c >> d) & 1 for d in range(n_dims)] for c in range(n)], np.uint32)


# --- tcnn parameter layout ---------------------------------------------------


def tcnn_grid_level_sizes(cfg: HashGridConfig) -> list[int]:
    """Rows per level in the tcnn grid param buffer (corner/vertex rows)."""
    sizes = []
    for l in range(cfg.n_levels):
        res = cfg.level_resolution(l)
        dense_rows = res**cfg.n_dims
        rows = min(cfg.table_size, -(-dense_rows // 8) * 8)  # next multiple of 8
        sizes.append(rows)
    return sizes


def _mlp_tcnn_dims(cfg: MLPConfig) -> list[tuple[int, int]]:
    """tcnn layer dims (n_out, n_in), final output padded to 16."""
    dims = [(n_out, n_in) for (n_in, n_out) in mlp_layer_dims(cfg)]
    out, inn = dims[-1]
    dims[-1] = (-(-out // 16) * 16, inn)
    return dims


def split_tcnn_params(
    params: np.ndarray,
    grid_cfg: HashGridConfig,
    density_cfg: MLPConfig,
    rgb_cfg: MLPConfig,
) -> dict:
    """Slice a flat tcnn param vector into our pytree (corner layout).

    Order per nerf_network.h:356-371: density MLP, rgb MLP, grid, dir (0).
    Returns {"density_mlp": [W...], "rgb_mlp": [W...], "grid": (L,T,F)}.
    """
    F = grid_cfg.n_features_per_level
    pos = 0

    def take(n):
        nonlocal pos
        out = params[pos : pos + n]
        if out.size != n:
            raise ValueError(f"param buffer too small: need {pos + n}, have {params.size}")
        pos += n
        return out

    def take_mlp(cfg: MLPConfig):
        ws = []
        for (n_out, n_in), (d_in, d_out) in zip(_mlp_tcnn_dims(cfg), mlp_layer_dims(cfg)):
            w = take(n_out * n_in).reshape(n_out, n_in)
            ws.append(np.ascontiguousarray(w[:d_out, :d_in].T.astype(np.float32)))
        return ws

    density = take_mlp(density_cfg)
    rgb = take_mlp(rgb_cfg)

    grid = np.zeros((grid_cfg.n_levels, grid_cfg.table_size, F), np.float32)
    for l, rows in enumerate(tcnn_grid_level_sizes(grid_cfg)):
        vals = take(rows * F).reshape(rows, F)
        grid[l, :rows] = vals.astype(np.float32)
    return {"density_mlp": density, "rgb_mlp": rgb, "grid": grid}


def join_tcnn_params(
    tree: dict,
    grid_cfg: HashGridConfig,
    density_cfg: MLPConfig,
    rgb_cfg: MLPConfig,
    dtype=np.float16,
) -> np.ndarray:
    """Inverse of split_tcnn_params; `tree["grid"]` must be corner layout."""
    parts = []
    for cfg, key in ((density_cfg, "density_mlp"), (rgb_cfg, "rgb_mlp")):
        for (n_out, n_in), w in zip(_mlp_tcnn_dims(cfg), tree[key]):
            buf = np.zeros((n_out, n_in), np.float32)
            wt = np.asarray(w, np.float32).T
            buf[: wt.shape[0], : wt.shape[1]] = wt
            parts.append(buf.reshape(-1))
    grid = np.asarray(tree["grid"], np.float32)
    for l, rows in enumerate(tcnn_grid_level_sizes(grid_cfg)):
        parts.append(grid[l, :rows].reshape(-1))
    return np.concatenate(parts).astype(dtype)


def cell_to_corner_table(cfg: HashGridConfig, cell_table: np.ndarray) -> np.ndarray:
    """Convert our (L,T,2^D,F) cell-layout table to (L,T,F) corner layout.

    Hash levels: cell row r's slot 0 holds the feature of the corner with
    the SAME coords as the cell base, and both layouts hash those coords
    identically — so corner[r] = cell[r, 0] row-for-row.  Dense levels:
    gather each corner's value from the containing cell's matching slot.
    """
    L, T, C, F = cell_table.shape
    D = cfg.n_dims
    out = np.zeros((L, T, F), cell_table.dtype)
    for l in range(L):
        if not cfg.level_is_dense(l):
            # hash level: same coords hash identically in both layouts
            out[l] = cell_table[l, :, 0]
            continue
        res = cfg.level_resolution(l)
        n_cells_dim = max(res - 1, 1)
        cr = np.stack(
            np.meshgrid(*([np.arange(res)] * D), indexing="ij"), axis=-1
        ).reshape(-1, D)
        base = np.minimum(cr, n_cells_dim - 1)
        slot_bits = cr - base  # 0/1 per dim
        slot = np.zeros(cr.shape[0], np.int64)
        for d in range(D):
            slot |= slot_bits[:, d].astype(np.int64) << d
        cell_row = np.zeros(cr.shape[0], np.int64)
        stride = 1
        for d in range(D):
            cell_row += base[:, d].astype(np.int64) * stride
            stride *= n_cells_dim
        if res**D <= T:  # corner layout also dense: stride placement
            corner_row = np.zeros(cr.shape[0], np.int64)
            stride = 1
            for d in range(D):
                corner_row += cr[:, d].astype(np.int64) * stride
                stride *= res
        else:  # cell-dense but corner-hashed boundary level
            corner_row = np.zeros(cr.shape[0], np.uint64)
            for d in range(D):
                corner_row ^= (cr[:, d].astype(np.uint64) * np.uint64(_PRIMES[d])) & np.uint64(
                    0xFFFFFFFF
                )
            corner_row = (corner_row & np.uint64(T - 1)).astype(np.int64)
        out[l, corner_row] = cell_table[l, cell_row, slot]
    return out


def corner_to_cell_table(
    cfg: HashGridConfig, corner_table: np.ndarray, max_cells: int = 1 << 24
) -> np.ndarray:
    """Expand a (L,T,F) corner/vertex table into our (L,T,2^D,F) cell layout.

    Exact for every level whose cell count fits `max_cells` (each cell's 2^D
    corner features are gathered from the corner table; colliding cells
    resolve last-write, mirroring how the cell layout trains).  Finer hash
    levels cannot be enumerated — use `layout="corner"` configs for imported
    snapshots instead (import_ingp does this by default).
    """
    L, T, F = corner_table.shape
    D = cfg.n_dims
    C = 1 << D
    out = np.zeros((L, T, C, F), corner_table.dtype)
    offs = _corner_offsets(D).astype(np.int64)  # (C,D)
    for l in range(L):
        res = cfg.level_resolution(l)
        n_cells_dim = max(res - 1, 1)
        if n_cells_dim**D > max_cells:
            raise ValueError(
                f"level {l}: {n_cells_dim}^{D} cells exceed max_cells; "
                "import with encoding.layout='corner' instead"
            )
        cells = np.stack(
            np.meshgrid(*([np.arange(n_cells_dim)] * D), indexing="ij"), axis=-1
        ).reshape(-1, D)

        # corner rows under CORNER-layout semantics (stride over res)
        for s in range(C):
            cc = np.minimum(cells + offs[s], res - 1)
            if res**D <= T:
                crow = np.zeros(cc.shape[0], np.int64)
                stride = 1
                for d in range(D):
                    crow += cc[:, d] * stride
                    stride *= res
            else:
                crow = np.zeros(cc.shape[0], np.uint64)
                for d in range(D):
                    crow ^= (cc[:, d].astype(np.uint64) * np.uint64(_PRIMES[d])) & np.uint64(
                        0xFFFFFFFF
                    )
                crow = (crow & np.uint64(T - 1)).astype(np.int64)
            # cell rows under CELL-layout semantics (stride over res-1)
            if n_cells_dim**D <= T:
                crow_cell = np.zeros(cells.shape[0], np.int64)
                stride = 1
                for d in range(D):
                    crow_cell += cells[:, d] * stride
                    stride *= n_cells_dim
            else:
                crow_cell = np.zeros(cells.shape[0], np.uint64)
                for d in range(D):
                    crow_cell ^= (
                        cells[:, d].astype(np.uint64) * np.uint64(_PRIMES[d])
                    ) & np.uint64(0xFFFFFFFF)
                crow_cell = (crow_cell & np.uint64(T - 1)).astype(np.int64)
            out[l, crow_cell, s] = corner_table[l, crow]
    return out


def import_ingp(path: str | Path) -> dict:
    """Load a reference snapshot into framework-native pieces.

    Returns {"config": network-config dict (with encoding.layout="corner"),
    "params": pytree, "density_grid": (C,G,G,G) fp32 or None, "meta": {...}}.
    """
    cfg = load_ingp(path)
    snap = cfg.get("snapshot")
    if snap is None:
        raise ValueError(f"{path}: no 'snapshot' key (not a snapshot file?)")
    if int(snap.get("version", 0)) < SNAPSHOT_FORMAT_VERSION:
        raise ValueError("Snapshot uses an old format and can not be loaded.")

    net_cfg = {k: v for k, v in cfg.items() if k != "snapshot"}
    enc = dict(net_cfg.get("encoding", {}))
    enc["layout"] = "corner"  # tcnn vertex tables import exactly as corner layout
    net_cfg["encoding"] = enc

    aabb_scale = float(snap.get("nerf", {}).get("aabb_scale", 1))
    grid_cfg = HashGridConfig.from_network_config(enc, n_dims=3, aabb_scale=aabb_scale)
    density_cfg = MLPConfig.from_network_config(
        net_cfg.get("network", {}), grid_cfg.n_output_dims, N_GEO_FEATURES
    )
    n_extra = int(snap.get("nerf", {}).get("dataset", {}).get("n_extra_learnable_dims", 0) or 0)
    sh_degree = 4
    for entry in net_cfg.get("dir_encoding", {}).get("nested", []):
        if str(entry.get("otype", "")).lower() == "sphericalharmonics":
            sh_degree = int(entry.get("degree", 4))
    rgb_cfg = MLPConfig.from_network_config(
        net_cfg.get("rgb_network", {}), sh_degree**2 + n_extra + N_GEO_FEATURES, 3
    )

    ptype = snap.get("params_type", "__half")
    pdtype = np.float16 if ptype == "__half" else np.float32
    pb = snap.get("params_binary")
    if pb is None:
        raise ValueError("snapshot has no params_binary")
    params_flat = np.frombuffer(bytes(pb), dtype=pdtype).astype(np.float32)
    params = split_tcnn_params(params_flat, grid_cfg, density_cfg, rgb_cfg)

    density_grid = None
    if "density_grid_binary" in snap:
        g = int(snap.get("density_grid_size", 128))
        flat = np.frombuffer(bytes(snap["density_grid_binary"]), dtype=np.float16)
        if flat.size:
            density_grid = density_grid_from_morton(flat.astype(np.float32), g)

    meta = {
        "mode": snap.get("mode", "nerf"),
        "training_step": int(snap.get("training_step", 0)),
        "loss": float(snap.get("loss", 0.0)),
        "aabb_scale": aabb_scale,
        "n_extra_learnable_dims": n_extra,
        "dataset": snap.get("nerf", {}).get("dataset"),
    }
    return {"config": net_cfg, "params": params, "density_grid": density_grid, "meta": meta}


def _host(x):
    """A tensor (on any device), a list of them, or an array -> numpy."""
    if isinstance(x, (list, tuple)):
        return [_host(v) for v in x]
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return x


def export_ingp(
    path: str | Path,
    network_config: dict,
    params: dict,
    grid_cfg: HashGridConfig,
    density_cfg: MLPConfig,
    rgb_cfg: MLPConfig,
    density_grid: np.ndarray | None = None,
    aabb_scale: float = 1.0,
    training_step: int = 0,
    loss: float = 0.0,
    mode: str = "nerf",
    compress: bool = True,
) -> None:
    """Write a reference-compatible snapshot from framework state (numpy
    arrays, or tensors on any device).  One 3-D hash table only: the
    triplane's three planes have no tcnn layout in the reference's format,
    and raise."""
    tree = {k: _host(v) for k, v in params.items()}
    if isinstance(tree.get("grid"), (list, tuple)) or isinstance(grid_cfg, tuple):
        raise NotImplementedError("export_ingp writes one 3-D hash table; a triplane network "
                                  "has three 2-D planes and no .ingp layout")
    grid = np.asarray(tree["grid"])
    if grid.ndim == 4:  # cell layout -> corner for the tcnn buffer
        import dataclasses

        tree["grid"] = cell_to_corner_table(grid_cfg, grid)
        grid_cfg = dataclasses.replace(grid_cfg, layout="corner")
    flat = join_tcnn_params(tree, grid_cfg, density_cfg, rgb_cfg, dtype=np.float16)
    snap = {
        "version": SNAPSHOT_FORMAT_VERSION,
        "mode": mode,
        "training_step": int(training_step),
        "loss": float(loss),
        "n_params": int(flat.size),
        "params_type": "__half",
        "params_binary": flat.tobytes(),
        "density_grid_size": int(density_grid.shape[1]) if density_grid is not None else 128,
        "nerf": {
            "aabb_scale": aabb_scale,
            "rgb": {
                "rays_per_batch": 4096,
                "measured_batch_size": 1 << 18,
                "measured_batch_size_before_compaction": 1 << 18,
            },
        },
    }
    if density_grid is not None:
        snap["density_grid_binary"] = (
            density_grid_to_morton(np.asarray(_host(density_grid), np.float32))
            .astype(np.float16).tobytes()
        )
    out = dict(network_config)
    out["snapshot"] = snap
    save_ingp(path, out, compress=compress)
