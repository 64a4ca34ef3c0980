"""Triangle octree for the Takikawa (NGLOD-style) encoding (the port's copy
of the JAX package's geom/octree.py: the build is host numpy, the same
code; the device tables are int32 torch tensors).

Behavioral spec: reference triangle_octree.cuh:46-262 — BFS build over
[0,1]^3: a child cell exists iff its AABB touches a mesh triangle
(`bvh.touches_triangle`, :142); dual nodes (one per created node, incl.
root) carry 8 corner-vertex ids deduplicated per (x,y,z,depth) coordinate
(:163-199); traversal descends while children exist, visiting one dual node
per depth (:225-255).

Design: level-synchronous numpy build with per-cell triangle
pair lists and a vectorized exact triangle-box SAT test (on a thread pool
over chunks of candidates: depth 10 on 81,932 triangles is ~676 k nodes); the device-side
lookup tables are per-level SORTED cell codes + (n,8) vertex-id rows, so
the encoding resolves a query cell with one `searchsorted` per level (no
pointer chasing on device).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np


def _tri_box_overlap(tris: np.ndarray, centers: np.ndarray, half: float) -> np.ndarray:
    """Exact triangle-AABB SAT (Akenine-Moller).  tris (M,3,3), centers
    (M,3), half scalar half-extent.  Returns (M,) bool."""
    v = tris - centers[:, None, :]  # (M,3,3) verts relative to box center
    h = np.full(3, half)

    # 1) box face axes (max / min over the 3 vertices as two elementwise
    # steps: exact, and much faster than numpy's reduce over a length-3 axis)
    vmax = np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2])
    vmin = np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2])
    ok = ~((vmax < -half) | (vmin > half)).any(axis=-1)  # AABB overlap on x/y/z

    e = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1], v[:, 0] - v[:, 2]], axis=1)  # (M,3,3)

    # 2) triangle normal plane
    n = np.cross(e[:, 0], e[:, 1])  # (M,3)
    d = -np.einsum("md,md->m", n, v[:, 0])
    r = np.einsum("md->m", np.abs(n) * h)
    s = d  # plane through origin-centered box: distance at center = d
    ok &= np.abs(s) <= r

    # 3) 9 cross-product axes a = e_i x unit_j
    for i in range(3):
        ei = e[:, i]
        for j in range(3):
            a = np.zeros_like(ei)
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            a[:, j1] = -ei[:, j2]
            a[:, j2] = ei[:, j1]
            p = np.einsum("md,mkd->mk", a, v)  # (M,3) vertex projections
            rad = (np.abs(a) * h).sum(axis=-1)
            pmin = np.minimum(np.minimum(p[:, 0], p[:, 1]), p[:, 2])
            pmax = np.maximum(np.maximum(p[:, 0], p[:, 1]), p[:, 2])
            ok &= ~((pmin > rad) | (pmax < -rad))
    return ok


_SAT_CHUNK = 1 << 16


def _tri_box_overlap_threads(tris: np.ndarray, centers: np.ndarray, half: float) -> np.ndarray:
    """_tri_box_overlap over chunks of candidates on a thread pool (numpy
    releases the GIL in its loops; each candidate's test is its own, so the
    result is the one-call result)."""
    n = len(tris)
    if n <= _SAT_CHUNK:
        return _tri_box_overlap(tris, centers, half)
    starts = range(0, n, _SAT_CHUNK)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        parts = ex.map(lambda s: _tri_box_overlap(tris[s:s + _SAT_CHUNK],
                                                  centers[s:s + _SAT_CHUNK], half), starts)
        return np.concatenate(list(parts))


@dataclass
class TriangleOctree:
    """Per-level lookup tables (lists indexed by depth 0..depth-1)."""

    depth: int
    n_vertices: int
    codes: list  # [d] -> (n_d,) sorted int64 packed cell codes
    verts: list  # [d] -> (n_d, 8) int32 global vertex ids (sorted like codes)
    n_nodes: int = 0

    def level_cells(self, d: int) -> np.ndarray:
        """Unpack level-d codes back to (n,3) integer cell coords."""
        s = 1 << d
        c = self.codes[d]
        return np.stack([c // (s * s), (c // s) % s, c % s], axis=-1)


def _pack(cells: np.ndarray, d: int) -> np.ndarray:
    s = np.int64(1 << d)
    c = cells.astype(np.int64)
    return (c[:, 0] * s + c[:, 1]) * s + c[:, 2]


_CHILD_OFFS = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int64
)


def build_triangle_octree(triangles: np.ndarray, max_depth: int) -> TriangleOctree:
    """Build to `max_depth` dual levels over the unit cube."""
    tris = np.asarray(triangles, np.float64).reshape(-1, 3, 3)
    levels_codes = []
    levels_cells = []
    # level 0: root cell
    cells = np.zeros((1, 3), np.int64)
    pair_cell = np.zeros(len(tris), np.int64)  # parent list: every tri in root
    pair_tri = np.arange(len(tris))
    levels_cells.append(cells)
    levels_codes.append(_pack(cells, 0))

    for d in range(1, max_depth):
        # candidate children: each parent's (cell,tri) pairs x 8 child cells
        parent_cells = levels_cells[d - 1][pair_cell]  # (P,3)
        cand_cells = (parent_cells[:, None, :] * 2 + _CHILD_OFFS[None, :, :]).reshape(-1, 3)
        cand_tris = np.repeat(pair_tri, 8)
        size = 1.0 / (1 << d)
        centers = (cand_cells + 0.5) * size
        hit = _tri_box_overlap_threads(tris[cand_tris], centers, size / 2)
        cand_cells = cand_cells[hit]
        cand_tris = cand_tris[hit]
        codes = _pack(cand_cells, d)
        order = np.argsort(codes, kind="stable")
        codes_s = codes[order]
        uniq_codes, inv_first = np.unique(codes_s, return_index=True)
        s = np.int64(1 << d)
        uniq_cells = np.stack(
            [uniq_codes // (s * s), (uniq_codes // s) % s, uniq_codes % s], axis=-1
        )
        if len(uniq_cells) == 0:
            break
        levels_cells.append(uniq_cells)
        levels_codes.append(uniq_codes)
        # new pair lists reference level-d cell indices
        pair_cell = np.searchsorted(uniq_codes, codes_s)
        pair_tri = cand_tris[order]

    depth = len(levels_cells)
    # dual vertices: per level, dedup corners of that level's cells
    n_vertices = 0
    verts = []
    codes_out = []
    n_nodes = 0
    for d, cells in enumerate(levels_cells):
        corners = (cells[:, None, :] + _CHILD_OFFS[None, :, :]).reshape(-1, 3)  # (n*8,3)
        ccodes = _pack(corners, d + 1)  # corner grid is (2^d + 1) wide; pack at d+1 is safe
        uniq, inv = np.unique(ccodes, return_inverse=True)
        vid = (inv + n_vertices).astype(np.int32).reshape(-1, 8)
        n_vertices += len(uniq)
        verts.append(vid)
        codes_out.append(levels_codes[d])
        n_nodes += len(cells)
    return TriangleOctree(depth=depth, n_vertices=n_vertices, codes=codes_out, verts=verts, n_nodes=n_nodes)


def octree_device_tables(tree: TriangleOctree, device=None) -> dict:
    """Per-level tables for the device encoding, {"codes_<d>": sorted
    int32 (n_d,), "verts_<d>": int32 (n_d, 8)} on `device`.

    A packed level-d code is < 2^(3d) + 2^(2d+1), so any depth <= 10 (the
    reference's takikawa config maximum, configs/sdf/takikawa.json
    n_levels=10) fits int32; a deeper tree raises."""
    import torch

    out = {}
    for d in range(tree.depth):
        codes = tree.codes[d]
        if len(codes) and int(codes[-1]) > np.iinfo(np.int32).max:
            raise ValueError(f"octree level {d} codes overflow int32 (depth too large)")
        out[f"codes_{d}"] = torch.from_numpy(codes.astype(np.int32)).to(device)
        out[f"verts_{d}"] = torch.from_numpy(np.ascontiguousarray(tree.verts[d])).to(device)
    return out
