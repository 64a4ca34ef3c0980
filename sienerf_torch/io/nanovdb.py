"""NanoVDB (.nvdb) float grids, read into a dense grid and written from one
(port of the JAX package's io/nanovdb.py): uncompressed single-grid files
of format v32.3 (FileHeader, MetaData, GridData, TreeData, 8^3 leaves);
the reader densifies the leaves over the grid's index bounding box.  A
written file is byte for byte the JAX package's.

Both directions work on all leaves at once as numpy records (a 256^3 grid
has 32,768 leaves), not leaf by leaf."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

NANOVDB_MAGIC = 0x304244566F6E614E  # "NanoVDB0"
_META_FMT = "<QQQQII6d6i3dI4I3IHHI"
_GRID_DATA = 672  # GridData header bytes (v32.3)
_TREE = 64 + 16 + 16  # node offsets, node counts, tile counts
# a leaf: CoordBBox slot (origin + padding), value mask, min/max/avg/std,
# then 512 values in [x][y][z] order
_LEAF = np.dtype([("origin", "<i4", 3), ("pad", "V20"), ("mask", "u1", 64),
                  ("stats", "<f4", 4), ("values", "<f4", 512)])
_VERSION = (32 << 21) | (3 << 10)
_CHUNK = 4096  # leaves densified at a time


@dataclass
class DenseVolume:
    density: np.ndarray  # (D, H, W) float32, (z, y, x)
    bbox_min: np.ndarray  # world-space min
    bbox_max: np.ndarray
    majorant: float


def read_nanovdb(path: str | Path) -> DenseVolume:
    data = Path(path).read_bytes()
    (magic,) = struct.unpack_from("<Q", data, 0)
    if magic != NANOVDB_MAGIC:
        raise IOError(f"{path}: not a NanoVDB file (magic {magic:#x})")
    _version, _n_grids, codec = struct.unpack_from("<IHH", data, 8)
    if codec != 0:
        raise IOError(f"{path}: compressed NanoVDB (codec {codec}) not supported")
    off = 16
    m = struct.unpack_from(_META_FMT, data, off)
    grid_size, grid_type = m[0], m[4]
    world_bbox = np.asarray(m[6:12])
    index_bbox = np.asarray(m[12:18], np.int64)
    off += struct.calcsize(_META_FMT) + int(m[21])
    if grid_type != 1:  # 1 = float
        raise IOError(f"{path}: only float grids supported (type {grid_type})")
    return _decode_float_grid(data[off:off + grid_size], world_bbox, index_bbox)


def _decode_float_grid(blob: bytes, world_bbox, index_bbox) -> DenseVolume:
    node_offset_leaf = struct.unpack_from("<Q", blob, _GRID_DATA)[0]
    n_leaf = struct.unpack_from("<I", blob, _GRID_DATA + 64)[0]
    lo, hi = index_bbox[:3], index_bbox[3:]
    dims = (hi - lo + 1).astype(np.int64)  # (x, y, z)
    dense = np.zeros((int(dims[2]), int(dims[1]), int(dims[0])), np.float32)
    leaves = np.frombuffer(blob, _LEAF, n_leaf, _GRID_DATA + node_offset_leaf)
    org = leaves["origin"].astype(np.int64) - lo[None, :]
    if len(np.unique(org, axis=0)) != len(org):
        # leaves that share voxels combine by their maximum, one at a time
        for o, v in zip(org, leaves["values"]):
            _max_into(dense, o, v.reshape(8, 8, 8), dims)
    else:
        r = np.arange(8)
        for s in range(0, n_leaf, _CHUNK):
            o = org[s:s + _CHUNK]
            x = o[:, 0, None, None, None] + r[None, :, None, None]
            y = o[:, 1, None, None, None] + r[None, None, :, None]
            z = o[:, 2, None, None, None] + r[None, None, None, :]
            ok = ((x >= 0) & (x < dims[0]) & (y >= 0) & (y < dims[1])
                  & (z >= 0) & (z < dims[2]))
            x, y, z = (np.broadcast_to(c, ok.shape)[ok] for c in (x, y, z))
            vals = leaves["values"][s:s + _CHUNK].reshape(-1, 8, 8, 8)[ok]
            dense[z, y, x] = np.maximum(dense[z, y, x], vals)
    return DenseVolume(density=dense, bbox_min=world_bbox[:3].astype(np.float32),
                       bbox_max=world_bbox[3:].astype(np.float32),
                       majorant=float(dense.max()) if dense.size else 0.0)


def _max_into(dense: np.ndarray, o: np.ndarray, vxyz: np.ndarray, dims: np.ndarray) -> None:
    """Max one leaf ([x][y][z] values at index origin o) into dense (z, y, x),
    clipped to the grid."""
    vzyx = np.transpose(vxyz, (2, 1, 0))
    x0, y0, z0 = (int(c) for c in o)
    sx, sy, sz = max(0, -x0), max(0, -y0), max(0, -z0)
    ex, ey, ez = min(8, int(dims[0]) - x0), min(8, int(dims[1]) - y0), min(8, int(dims[2]) - z0)
    if ex <= sx or ey <= sy or ez <= sz:
        return
    dst = dense[z0 + sz:z0 + ez, y0 + sy:y0 + ey, x0 + sx:x0 + ex]
    np.maximum(dst, vzyx[sz:ez, sy:ey, sx:ex], out=dst)


def write_nanovdb(path: str | Path, density: np.ndarray,
                  bbox_min=(0.0, 0.0, 0.0), bbox_max=(1.0, 1.0, 1.0)) -> None:
    """Write a dense (D, H, W) float32 grid as an uncompressed single-grid
    NanoVDB file (v32.3): every 8^3 block with a non-zero value becomes a
    leaf at its index-space origin, in z, y, x block order; the upper,
    lower and root nodes are left empty."""
    dense = np.asarray(density, np.float32)
    D, H, W = dense.shape
    nz, ny, nx = -(-D // 8), -(-H // 8), -(-W // 8)
    pad = np.zeros((nz * 8, ny * 8, nx * 8), np.float32)
    pad[:D, :H, :W] = dense
    blocks = pad.reshape(nz, 8, ny, 8, nx, 8).transpose(0, 2, 4, 1, 3, 5).reshape(-1, 8, 8, 8)
    keep = blocks.reshape(len(blocks), -1).any(axis=1)
    bz, by, bx = np.unravel_index(np.nonzero(keep)[0], (nz, ny, nx))
    blk = np.ascontiguousarray(blocks[keep])  # [z][y][x]
    vxyz = blk.transpose(0, 3, 2, 1).reshape(len(blk), 512)
    leaves = np.zeros(len(blk), _LEAF)
    leaves["origin"] = np.stack([bx * 8, by * 8, bz * 8], axis=-1)
    leaves["mask"] = np.packbits(vxyz != 0, axis=1, bitorder="little")
    flat = blk.reshape(len(blk), 512)
    leaves["stats"][:, 0] = flat.min(axis=1)
    leaves["stats"][:, 1] = flat.max(axis=1)
    leaves["stats"][:, 2] = [b.mean() for b in blk]  # numpy's own f32 mean, as written per leaf
    leaves["values"] = vxyz
    leaf_blob = leaves.tobytes()
    n_leaf = len(leaves)

    leaf_off = _TREE
    tree = struct.pack("<8Q", leaf_off, leaf_off + len(leaf_blob), leaf_off + len(leaf_blob),
                       leaf_off + len(leaf_blob), 0, 0, 0, 0)
    tree += struct.pack("<4I", n_leaf, 0, 0, 0)
    tree += b"\x00" * (_TREE - len(tree))

    grid_name = b"density"
    wmin = np.asarray(bbox_min, np.float64)
    wmax = np.asarray(bbox_max, np.float64)
    voxel = (wmax - wmin) / np.maximum(np.asarray([W, H, D], np.float64), 1.0)
    gd = bytearray(_GRID_DATA)
    struct.pack_into("<Q", gd, 0, NANOVDB_MAGIC)
    struct.pack_into("<Q", gd, 8, 0)  # checksum (none)
    struct.pack_into("<I", gd, 16, _VERSION)
    struct.pack_into("<I", gd, 20, 0)  # flags
    struct.pack_into("<I", gd, 24, 0)  # gridIndex
    struct.pack_into("<I", gd, 28, 1)  # gridCount
    grid_size = _GRID_DATA + _TREE + len(leaf_blob)
    struct.pack_into("<Q", gd, 32, grid_size)
    gd[40:40 + len(grid_name)] = grid_name
    # the map: index -> world scales by the voxel size, f32 then f64 copies
    matf, invf = np.zeros((3, 3), "<f4"), np.zeros((3, 3), "<f4")
    matd, invd = np.zeros((3, 3), "<f8"), np.zeros((3, 3), "<f8")
    for a in range(3):
        matf[a, a] = matd[a, a] = voxel[a]
        invf[a, a] = invd[a, a] = 1.0 / voxel[a]
    gd[296:332] = matf.tobytes()
    gd[332:368] = invf.tobytes()
    gd[368:380] = np.asarray(wmin, "<f4").tobytes()
    struct.pack_into("<f", gd, 380, 1.0)
    gd[384:456] = matd.tobytes()
    gd[456:528] = invd.tobytes()
    gd[528:552] = np.asarray(wmin, "<f8").tobytes()
    struct.pack_into("<d", gd, 552, 1.0)
    struct.pack_into("<6d", gd, 560, *wmin, *wmax)  # world bbox
    struct.pack_into("<3d", gd, 608, *voxel)
    struct.pack_into("<I", gd, 632, 1)  # gridClass: FogVolume
    struct.pack_into("<I", gd, 636, 1)  # gridType: float
    meta = struct.pack(_META_FMT, grid_size, grid_size, 0, int((dense != 0).sum()), 1, 1,
                       *wmin, *wmax, 0, 0, 0, W - 1, H - 1, D - 1, *voxel,
                       len(grid_name), n_leaf, 0, 0, 0, 0, 0, 0, 0, 0, _VERSION)
    header = struct.pack("<QIHH", NANOVDB_MAGIC, _VERSION, 1, 0)
    with open(Path(path), "wb") as f:
        f.write(header + meta + grid_name + bytes(gd) + tree + leaf_blob)


def synthetic_fog_volume(res: int = 64, kind: str = "sphere") -> DenseVolume:
    """An analytic density volume built in code: a sphere (density 40 at
    the centre) or a shell (density 30 at radius 0.3, width 0.05)."""
    z, y, x = np.meshgrid(*([np.linspace(0, 1, res)] * 3), indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    if kind == "sphere":
        d = np.clip(1.0 - r / 0.35, 0.0, 1.0) ** 2 * 40.0
    elif kind == "shell":
        d = np.exp(-(((r - 0.3) / 0.05) ** 2)) * 30.0
    else:
        raise ValueError(kind)
    return DenseVolume(density=d.astype(np.float32), bbox_min=np.zeros(3, np.float32),
                       bbox_max=np.ones(3, np.float32), majorant=float(d.max()))
