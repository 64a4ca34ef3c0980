"""The repo's native BVH code, built with g++ at first use into
`sienerf_torch/csrc/build/` and called through ctypes (port of the JAX
package's geom/bvh_native.py): the builder `csrc/bvh_builder.cpp` and the
SDF mode's host ground truth `csrc/sdf_query.cpp` (signed distances on host
threads).  A build or a call that fails raises; nothing falls back to the
numpy builder or to the device queries (geom/bvh.py::build_bvh picks the
numpy builder, SdfEngine(host_gt=False) the device queries, only when
asked)."""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_BUILD = Path(__file__).resolve().parents[1] / "csrc" / "build"
_SRC, _SO = _CSRC / "bvh_builder.cpp", _BUILD / "bvh_builder.so"
_SDF_SRC, _SDF_SO = _CSRC / "sdf_query.cpp", _BUILD / "sdf_query.so"
_lib: ctypes.CDLL | None = None
_sdf_lib: ctypes.CDLL | None = None

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)


def _load(src: Path, so: Path, fn_name: str, argtypes: list) -> ctypes.CDLL:
    """Build `src` into `so` with g++ (when the .so is missing or older)
    and load it, declaring `fn_name`'s C signature."""
    if not src.exists():
        raise FileNotFoundError(f"{src} (native BVH code) is missing")
    if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
                               str(src), "-o", str(tmp)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src.name}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib


def _ensure_lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = _load(_SRC, _SO, "bvh_build", [
            _F, ctypes.c_int64, ctypes.c_int, _F, _F, _I, _I, _I, _I, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64)])
    return _lib


def _ensure_sdf_lib() -> ctypes.CDLL:
    global _sdf_lib
    if _sdf_lib is None:
        _sdf_lib = _load(_SDF_SRC, _SDF_SO, "sdf_query", [
            _F, ctypes.c_int64, _F, _F, _I, _I, _I, ctypes.c_int64, _F, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, _F])
    return _sdf_lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F)


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_I)


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
    rc = lib.bvh_build(_fp(tri), n, leaf_size, _fp(bbox_min), _fp(bbox_max), _ip(first_tri),
                       _ip(tri_count), _ip(skip), _ip(perm), max_nodes, ctypes.byref(n_nodes))
    if rc != 0:
        raise RuntimeError(f"bvh_build failed rc={rc}")
    m = n_nodes.value
    return (bbox_min[:m].copy(), bbox_max[:m].copy(), first_tri[:m].copy(),
            tri_count[:m].copy(), skip[:m].copy(), tri[perm], perm.copy())


def sdf_query(bvh, points: np.ndarray, mode: int = 0, n_threads: int = 0) -> np.ndarray:
    """Signed distances of (N, 3) points to a TriangleBVH's mesh, on
    `n_threads` host threads (default: the cores less one) -> (N,) f32.
    mode 0: the sign is the parity of one stab ray (watertight meshes);
    mode 1: outside when any of 32 Fibonacci stab rays escapes."""
    lib = _ensure_sdf_lib()
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    out = np.empty(len(pts), np.float32)
    tris = np.ascontiguousarray(bvh.triangles, np.float32)
    bmin = np.ascontiguousarray(bvh.bbox_min, np.float32)
    bmax = np.ascontiguousarray(bvh.bbox_max, np.float32)
    first = np.ascontiguousarray(bvh.first_tri, np.int32)
    count = np.ascontiguousarray(bvh.tri_count, np.int32)
    skip = np.ascontiguousarray(bvh.skip, np.int32)
    if n_threads <= 0:
        n_threads = max(1, (os.cpu_count() or 4) - 1)
    rc = lib.sdf_query(_fp(tris), len(tris), _fp(bmin), _fp(bmax), _ip(first), _ip(count),
                       _ip(skip), len(first), _fp(pts), len(pts), int(mode), int(n_threads),
                       _fp(out))
    if rc != 0:
        raise RuntimeError(f"sdf_query failed rc={rc}")
    return out
