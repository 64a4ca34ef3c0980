"""Triangle-mesh loading and saving: OBJ, STL and PLY (port of the JAX
package's geom/mesh_io.py; numpy on the host).

Behavioral spec: reference tinyobj_loader_wrapper.cu (OBJ -> flat triangle
list) and the STL loader at testbed_geometry_training.cu:2751-2784 (binary
and ASCII STL).  Meshes load as a flat (T, 3, 3) float32 triangle array;
normalization to the unit cube follows load_mesh
(testbed_geometry_training.cu:2786-2866): scale by 1/max-extent, center at
(0.5,0.5,0.5) plus a per-object center offset.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def load_obj(path: str | Path) -> np.ndarray:
    """Parse OBJ -> (T, 3, 3) triangles (fan-triangulated polygons)."""
    verts: list[list[float]] = []
    tris: list[tuple[int, int, int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
    v = np.asarray(verts, np.float32)
    t = np.asarray(tris, np.int64)
    return v[t]


def load_stl(path: str | Path) -> np.ndarray:
    """Parse binary or ASCII STL -> (T, 3, 3) triangles."""
    data = Path(path).read_bytes()
    if data[:5].lower() == b"solid" and b"facet" in data[:1000]:
        tris = []
        cur: list[list[float]] = []
        for line in data.decode(errors="replace").splitlines():
            line = line.strip()
            if line.startswith("vertex"):
                parts = line.split()
                cur.append([float(parts[1]), float(parts[2]), float(parts[3])])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
        return np.asarray(tris, np.float32)
    (n,) = struct.unpack_from("<I", data, 80)
    out = np.frombuffer(data, np.uint8, count=n * 50, offset=84)
    out = out.reshape(n, 50)[:, :48].copy().view(np.float32).reshape(n, 4, 3)
    return out[:, 1:4].astype(np.float32)  # drop the normal row


def load_mesh(path: str | Path) -> np.ndarray:
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".obj":
        return load_obj(path)
    if ext == ".stl":
        return load_stl(path)
    raise ValueError(f"unsupported mesh format {ext}")


def normalize_to_unit_cube(
    triangles: np.ndarray, center: np.ndarray | None = None, scale_margin: float = 1.0
) -> np.ndarray:
    """Scale the mesh isotropically into the unit cube centered at 0.5
    (+optional scene-graph center offset), reference load_mesh semantics."""
    tri = np.asarray(triangles, np.float32)
    lo = tri.reshape(-1, 3).min(axis=0)
    hi = tri.reshape(-1, 3).max(axis=0)
    size = float((hi - lo).max())
    if size <= 0:
        size = 1.0
    s = scale_margin / size
    mid = 0.5 * (lo + hi)
    out = (tri - mid) * s + 0.5
    if center is not None:
        out = out + (np.asarray(center, np.float32) - 0.5)
    return out


def triangle_normals(triangles: np.ndarray) -> np.ndarray:
    e1 = triangles[:, 1] - triangles[:, 0]
    e2 = triangles[:, 2] - triangles[:, 0]
    n = np.cross(e1, e2)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return n / np.maximum(norm, 1e-20)


def triangle_areas(triangles: np.ndarray) -> np.ndarray:
    e1 = triangles[:, 1] - triangles[:, 0]
    e2 = triangles[:, 2] - triangles[:, 0]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)


def save_obj(path: str | Path, vertices: np.ndarray, faces: np.ndarray,
             colors: np.ndarray | None = None, normals: np.ndarray | None = None) -> None:
    with open(path, "w") as f:
        for i, v in enumerate(vertices):
            if colors is not None:
                c = colors[i]
                f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
            else:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        if normals is not None:
            for vn in normals:
                f.write(f"vn {vn[0]} {vn[1]} {vn[2]}\n")
        for tri in faces:
            if normals is not None:
                f.write(f"f {tri[0] + 1}//{tri[0] + 1} {tri[1] + 1}//{tri[1] + 1} {tri[2] + 1}//{tri[2] + 1}\n")
            else:
                f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def save_ply(path: str | Path, vertices: np.ndarray, faces: np.ndarray,
             colors: np.ndarray | None = None, normals: np.ndarray | None = None) -> None:
    """Binary little-endian PLY: vertex rows of xyz f32 [+ normal f32]
    [+ rgb u8], then face rows of a u8 count 3 and three int32 ids, each
    table written as one packed numpy record array."""
    n_v, n_f = len(vertices), len(faces)
    hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {n_v}",
           "property float x", "property float y", "property float z"]
    fields = [("p", "<f4", (3,))]
    if normals is not None:
        hdr += ["property float nx", "property float ny", "property float nz"]
        fields.append(("n", "<f4", (3,)))
    if colors is not None:
        hdr += ["property uchar red", "property uchar green", "property uchar blue"]
        fields.append(("c", "u1", (3,)))
    hdr += [f"element face {n_f}", "property list uchar int vertex_indices", "end_header"]
    rows = np.empty(n_v, np.dtype(fields))
    rows["p"] = vertices
    if normals is not None:
        rows["n"] = normals
    if colors is not None:
        rows["c"] = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
    tris = np.empty(n_f, np.dtype([("k", "u1"), ("i", "<i4", (3,))]))
    tris["k"] = 3
    tris["i"] = faces
    with open(path, "wb") as f:
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(rows.tobytes())
        f.write(tris.tobytes())


def icosphere(subdivisions: int, radius: float = 1.0) -> np.ndarray:
    """A sphere of 20 * 4^subdivisions triangles, built in code -> (T, 3, 3)
    f32, outward winding: an icosahedron whose faces are split in four
    `subdivisions` times, each new vertex pushed onto the sphere."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([[-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
                      [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
                      [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]], np.float64)
    faces = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                      [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                      [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                      [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    tri = verts[faces]
    tri /= np.linalg.norm(tri, axis=-1, keepdims=True)
    for _ in range(subdivisions):
        a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
        ab, bc, ca = [m / np.linalg.norm(m, axis=-1, keepdims=True)
                      for m in ((a + b) / 2, (b + c) / 2, (c + a) / 2)]
        tri = np.concatenate([np.stack(f, axis=1) for f in
                              ((a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca))])
    return (tri * radius).astype(np.float32)


def box_mesh(lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0)) -> np.ndarray:
    """An axis-aligned box of 12 triangles, outward winding -> (12, 3, 3) f32."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    c = np.array([[lo[0] if i & 1 == 0 else hi[0], lo[1] if i & 2 == 0 else hi[1],
                   lo[2] if i & 4 == 0 else hi[2]] for i in range(8)], np.float32)
    quads = [(0, 2, 3, 1), (4, 5, 7, 6), (0, 1, 5, 4), (2, 6, 7, 3), (0, 4, 6, 2), (1, 3, 7, 5)]
    return np.stack([c[[q[0], q[1], q[2]]] for q in quads]
                    + [c[[q[0], q[2], q[3]]] for q in quads]).astype(np.float32)
