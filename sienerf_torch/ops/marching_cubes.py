"""Table-driven marching cubes on the host in numpy (port of the JAX
package's ops/marching_cubes.py; the device evaluates the field on the
grid, ops/meshing.py::density_on_grid).

The 256-case triangle table is generated when the module is imported, by
tracing iso-contour loops over the cube's faces with one face-ambiguity
rule (an ambiguous face never joins its inside corners).  The rule reads
only a face's own corner signs, so two cells agree on their shared face
and the mesh is watertight.  Conventions match meshing.surface_nets: the
grid is (R, R, R) in (z, y, x) order, "inside" is value < iso, vertices
are welded on lattice edges and placed at (idx + 0.5) / R * aabb_diag +
aabb_min.
"""

from __future__ import annotations

import numpy as np

# corner i position (x, y, z); standard MC numbering
_CORNERS = np.array(
    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
     (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)], np.int32)
# edge i = (corner a, corner b); standard MC numbering
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]
# cube faces as corner cycles, CCW viewed from OUTSIDE the cube
_FACES = [
    (0, 3, 2, 1),  # z=0, outward -z
    (4, 5, 6, 7),  # z=1, outward +z
    (0, 1, 5, 4),  # y=0, outward -y
    (2, 3, 7, 6),  # y=1, outward +y
    (0, 4, 7, 3),  # x=0, outward -x
    (1, 2, 6, 5),  # x=1, outward +x
]

_EDGE_ID = {frozenset(e): i for i, e in enumerate(_EDGES)}


def _case_loops(inside):
    """Trace directed iso-contour loops for one corner configuration.

    Returns a list of loops, each a list of edge indices (0..11), wound
    so that triangle normals point from the inside (value < iso) region
    toward the outside.
    """
    # directed segments: crossing edge -> crossing edge across one face
    nxt = {}
    for face in _FACES:
        bedges = [(face[i], face[(i + 1) % 4]) for i in range(4)]
        cross = [i for i, (a, b) in enumerate(bedges) if inside[a] != inside[b]]
        if not cross:
            continue
        # maximal cyclic runs of consecutive inside corners; each run's
        # bounding crossing edges form one contour segment (this is the
        # "never join inside corners across an ambiguous face" rule)
        for i in range(4):
            if not inside[face[i]]:
                continue
            # walk back to the start of this run
            if inside[face[(i - 1) % 4]]:
                continue
            j = i
            while inside[face[(j + 1) % 4]]:
                j = (j + 1) % 4
            e_in = _EDGE_ID[frozenset(bedges[(i - 1) % 4])]
            e_out = _EDGE_ID[frozenset(bedges[j])]
            # walking CCW (outside view) the inside run sits between
            # e_in and e_out; directing the segment e_in -> e_out makes
            # fan normals point away from the inside (value < iso)
            # region — same winding as meshing.surface_nets
            nxt[e_in] = e_out
    loops = []
    seen = set()
    for start in list(nxt):
        if start in seen:
            continue
        loop, e = [], start
        while True:
            loop.append(e)
            seen.add(e)
            e = nxt[e]
            if e == start:
                break
        loops.append(loop)
    return loops


def _build_tables():
    rows = []
    for case in range(256):
        inside = [(case >> c) & 1 == 1 for c in range(8)]
        tris = []
        for loop in _case_loops(inside):
            for k in range(1, len(loop) - 1):
                tris.append((loop[0], loop[k], loop[k + 1]))
        rows.append(tris)
    width = max(len(t) for t in rows)
    table = np.full((256, width, 3), -1, np.int8)
    for case, tris in enumerate(rows):
        for i, t in enumerate(tris):
            table[case, i] = t
    return table


TRI_TABLE = _build_tables()  # (256, MAX_TRIS, 3) of edge ids, -1 padded
MAX_TRIS = TRI_TABLE.shape[1]

# local edge id -> (axis, dz, dy, dx): the lattice edge of cell (z,y,x)
# along `axis` starting at corner offset (dz,dy,dx); axis 0=x,1=y,2=z
_EDGE_TO_LATTICE = []
for a, b in _EDGES:
    pa, pb = _CORNERS[a], _CORNERS[b]
    lo = np.minimum(pa, pb)
    axis = int(np.nonzero(pa != pb)[0][0])
    _EDGE_TO_LATTICE.append((axis, int(lo[2]), int(lo[1]), int(lo[0])))


def marching_cubes(grid: np.ndarray, iso: float, aabb_min, aabb_diag):
    """Extract an iso-surface triangle mesh with tabulated marching cubes.

    grid: (R,R,R) scalar field in (z,y,x) order. Returns
    (vertices (V,3) float32 world coords, faces (F,3) int32), vertices
    welded on shared lattice edges (one vertex per crossing edge), same
    coordinate convention as meshing.surface_nets.
    """
    g = np.asarray(grid, np.float32) - iso
    r = g.shape[0]
    inside = g < 0

    # ---- per-axis crossing-edge vertex ids + interpolated positions ----
    vert_chunks = []
    edge_ids = []
    n_verts = 0
    for axis, (ez, ey, ex) in enumerate([(0, 0, 1), (0, 1, 0), (1, 0, 0)]):
        a0 = g[0:r - ez, 0:r - ey, 0:r - ex]
        a1 = g[ez:r, ey:r, ex:r]
        crossing = (a0 < 0) != (a1 < 0)
        ids = np.full(crossing.shape, -1, np.int64)
        zz, yy, xx = np.nonzero(crossing)
        ids[zz, yy, xx] = n_verts + np.arange(len(zz))
        edge_ids.append(ids)
        va, vb = a0[zz, yy, xx], a1[zz, yy, xx]
        t = va / np.where(np.abs(va - vb) > 1e-12, va - vb, 1.0)
        p0 = np.stack([xx, yy, zz], axis=-1).astype(np.float64)
        d = np.array([ex, ey, ez], np.float64)  # (x,y,z) step of this edge
        vert_chunks.append(p0 + t[:, None] * d[None, :])
        n_verts += len(zz)
    if n_verts == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    verts = np.concatenate(vert_chunks, axis=0)

    # ---- per-cell case codes ----
    case = np.zeros((r - 1, r - 1, r - 1), np.uint8)
    for c, (cx, cy, cz) in enumerate(_CORNERS):
        case |= (inside[cz:r - 1 + cz, cy:r - 1 + cy, cx:r - 1 + cx]
                 .astype(np.uint8) << c)
    active = (case != 0) & (case != 255)
    az, ay, ax = np.nonzero(active)
    if len(az) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    acase = case[az, ay, ax]

    # ---- emit triangles: tri-table lookup -> lattice edge -> vertex id ----
    tri_edges = TRI_TABLE[acase]  # (A, MAX_TRIS, 3) local edge ids
    flat = tri_edges.reshape(len(az), -1)  # (A, MAX_TRIS*3)
    gids = np.empty_like(flat, dtype=np.int64)
    for le, (axis, dz, dy, dx) in enumerate(_EDGE_TO_LATTICE):
        m = flat == le
        if not m.any():
            continue
        ids_l = edge_ids[axis][az + dz, ay + dy, ax + dx]
        sel = np.broadcast_to(ids_l[:, None], flat.shape)
        gids[m] = sel[m]
    gids[flat < 0] = -1
    faces = gids.reshape(-1, 3)
    faces = faces[faces[:, 0] >= 0].astype(np.int32)

    world = (verts + 0.5) / r
    world = np.asarray(aabb_min) + world * np.asarray(aabb_diag)
    return world.astype(np.float32), faces
