"""Scene catalogs: named scenes (the NeRF fox and the NeRF-synthetic
scenes, image, SDF and geometry samples) with their data paths and
defaults, and resolve_scene, which maps a bare name to its data under the
given roots (port of the JAX package's scenes.py)."""

from __future__ import annotations

from pathlib import Path

SCENES_NERF = {
    "fox": {"data": "data/nerf/fox", "dataset_train": "", "dataset_test": "",
            "aabb_scale": 4},
    # the NeRF-synthetic (Blender) scenes; the data is not in the repo
    **{name: {"data": f"data/nerf_synthetic/{name}",
              "dataset_train": "transforms_train.json",
              "dataset_test": "transforms_test.json", "aabb_scale": 1}
       for name in ("lego", "chair", "drums", "ficus", "hotdog", "materials", "mic", "ship")},
}

SCENES_IMAGE = {"albert": {"data": "data/image/albert.exr"}}

SCENES_SDF = {
    "bunny": {"data": "data/geometry/objs/bunny.obj"},
    "armadillo": {"data": "data/geometry/objs/armadillo.obj"},
}

SCENES_GEOMETRY = {
    "geometrypaths": {"data": "data/geometry/geometrypaths.json"},
    "geometrypathsnerf": {"data": "data/geometry/geometrypathsnerf.json"},
}

ALL_SCENES = {**SCENES_NERF, **SCENES_IMAGE, **SCENES_SDF, **SCENES_GEOMETRY}

# the working directory, then the checkout (whose data/ holds the fox
# snapshot); the catalog's other data is not in the repo: pass its root
DEFAULT_DATA_ROOTS = (".", str(Path(__file__).resolve().parents[1]))


def resolve_scene(name_or_path: str, data_roots=DEFAULT_DATA_ROOTS) -> str:
    """An existing path, or a string no catalog names, as it is; a bare
    scene name -> its data path under the first of `data_roots` that holds
    it (FileNotFoundError where none does)."""
    p = Path(name_or_path)
    if p.exists():
        return str(p)
    entry = ALL_SCENES.get(str(name_or_path))
    if entry is None:
        return str(name_or_path)
    for root in data_roots:
        cand = Path(root) / entry["data"]
        if cand.exists():
            return str(cand)
    raise FileNotFoundError(
        f"scene '{name_or_path}' maps to {entry['data']} but it was not found under "
        f"{data_roots}")
