"""The native BVH builder (port of the build half of the JAX package's
geom/bvh_native.py): the repo's C++ builder `csrc/bvh_builder.cpp`, built
with g++ at first use into `sienerf_torch/csrc/build/`, called through
ctypes.  A build or a call that fails raises; nothing falls back to the
numpy builder (geom/bvh.py::build_bvh picks that one only when asked)."""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "bvh_builder.cpp"
_SO = Path(__file__).resolve().parents[1] / "csrc" / "build" / "bvh_builder.so"
_lib = None


def _ensure_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _SRC.exists():
        raise FileNotFoundError(f"{_SRC} (the native BVH build) is missing")
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _SO.parent.mkdir(parents=True, exist_ok=True)
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                               str(_SRC), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, _SO)  # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(str(_SO))
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    _lib = lib
    return lib


def build(triangles: np.ndarray, leaf_size: int = 4):
    """(T, 3, 3) triangles -> the TriangleBVH fields (bbox_min, bbox_max,
    first_tri, tri_count, skip, triangles reordered, tri_index)."""
    lib = _ensure_lib()
    tri = np.ascontiguousarray(triangles, np.float32)
    n = len(tri)
    max_nodes = 4 * (n // leaf_size + 2) + 16
    bbox_min = np.empty((max_nodes, 3), np.float32)
    bbox_max = np.empty((max_nodes, 3), np.float32)
    first_tri = np.empty(max_nodes, np.int32)
    tri_count = np.empty(max_nodes, np.int32)
    skip = np.empty(max_nodes, np.int32)
    perm = np.empty(n, np.int32)
    n_nodes = ctypes.c_int64(0)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.bvh_build(
        p(tri, ctypes.c_float), n, leaf_size,
        p(bbox_min, ctypes.c_float), p(bbox_max, ctypes.c_float),
        p(first_tri, ctypes.c_int32), p(tri_count, ctypes.c_int32),
        p(skip, ctypes.c_int32), p(perm, ctypes.c_int32),
        max_nodes, ctypes.byref(n_nodes),
    )
    if rc != 0:
        raise RuntimeError(f"bvh_build failed rc={rc}")
    m = n_nodes.value
    return (bbox_min[:m].copy(), bbox_max[:m].copy(), first_tri[:m].copy(),
            tri_count[:m].copy(), skip[:m].copy(), tri[perm], perm.copy())
