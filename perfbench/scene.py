"""The meshes of a hybrid configuration, made from the run's seed, and the
scene-graph file the program loads.

A configuration's "scene" holds, for each mesh, its centre and scale as
the scene graph states them (the program normalises a mesh into the unit
cube, scales it, and moves its centre to 0.5 + "center"), and one shape
for all of them: a closed UV sphere of `n_lon` x `n_lat` cells whose radius
is displaced along each direction by a smooth seeded function (so the
surface stays star-shaped and watertight), plus `degenerate` zero-area
triangles that bring the count to a chosen total (a closed triangle mesh
has an even count).  The NeRF object is a slot without a path, filled by
GeometryEngine.attach_nerf with the configuration's field.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from perfbench import generator


def star_mesh(shape: dict, seed: int, index: int) -> tuple[np.ndarray, np.ndarray]:
    """One mesh -> (vertices (V, 3) f32, faces (F, 3) int64, 0-based)."""
    n_lon, n_lat = int(shape["n_lon"]), int(shape["n_lat"])
    r = generator.rng(seed, 100 + index)
    k = int(shape["n_waves"])
    freq = r.normal(size=(k, 3))
    freq *= (r.uniform(1.5, 4.0, size=k) / np.linalg.norm(freq, axis=1))[:, None]
    phase = r.uniform(0.0, 2.0 * math.pi, size=k)
    amp = r.uniform(0.5, 1.0, size=k)
    amp *= float(shape["bump"]) / amp.sum()
    theta = math.pi * np.arange(1, n_lat) / n_lat
    phi = 2.0 * math.pi * np.arange(n_lon) / n_lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi)[None], np.broadcast_to(ct, (n_lat - 1, n_lon)),
                     st * np.sin(phi)[None]], axis=-1).reshape(-1, 3)
    dirs = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    radius = 1.0 + np.sin(dirs @ freq.T + phase) @ amp
    verts = (dirs * radius[:, None]).astype(np.float32)
    top, bottom = 0, len(dirs) - 1

    def at(i, j):  # ring i (0 .. n_lat-2), column j
        return 1 + i * n_lon + (j % n_lon)

    faces = []
    j = np.arange(n_lon)
    faces.append(np.stack([np.full(n_lon, top), at(0, j + 1), at(0, j)], axis=1))
    for i in range(n_lat - 2):
        a, b, c, d = at(i, j), at(i, j + 1), at(i + 1, j), at(i + 1, j + 1)
        faces.append(np.stack([a, b, d], axis=1))
        faces.append(np.stack([a, d, c], axis=1))
    last = n_lat - 2
    faces.append(np.stack([np.full(n_lon, bottom), at(last, j), at(last, j + 1)], axis=1))
    faces.append(np.zeros((int(shape["degenerate"]), 3), np.int64))  # zero area: never hit
    return verts, np.concatenate(faces).astype(np.int64)


def triangle_count(shape: dict) -> int:
    return 2 * int(shape["n_lon"]) * (int(shape["n_lat"]) - 1) + int(shape["degenerate"])


def write_obj(path: Path, verts: np.ndarray, faces: np.ndarray) -> None:
    """Vertices as %.9g (an f32 reads back to its own bits), faces 1-based."""
    lines = ["v %.9g %.9g %.9g" % tuple(v) for v in verts.tolist()]
    lines += ["f %d %d %d" % tuple(f) for f in (faces + 1).tolist()]
    Path(path).write_text("\n".join(lines) + "\n")


def write_scene(config: dict, seed: int, directory: Path) -> Path:
    """The configuration's meshes as .obj files and its scene graph (one
    NeRF slot after the meshes) in `directory` -> the scene file, named
    so that the program reads it as a geometry scene."""
    directory = Path(directory)
    sc = config["scene"]
    entries = []
    for i, m in enumerate(sc["meshes"]):
        verts, faces = star_mesh(sc["shape"], seed, i)
        write_obj(directory / f"mesh{i}.obj", verts, faces)
        entries.append({"type": "Mesh", "path": f"mesh{i}.obj", "center": m["center"],
                        "scale": m["scale"]})
    entries.append({"type": "Nerf", "center": [0.0, 0.0, 0.0]})
    path = directory / "scene.geometry.json"
    path.write_text(json.dumps({"geometry": entries}))
    return path
