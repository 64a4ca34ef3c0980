"""K3, the stackless BVH walk of mesh rays: CUDA kernel wrapper.

The kernel is `csrc/bvh.cu` (one thread a ray over the flat arrays of
geom/bvh.py::TriangleBVH.as_device_arrays; its source note gives the
design).  Its plain version is geom/bvh.py::bvh_raytrace_plain, which the
card tests hold it to; geom/bvh.py::bvh_raytrace and bvh_any_hit send
CUDA tensors here.

Counters: `bvh_walk_kernel.launches`, always on, as the other kernels'
`.launches`; while the recorder records (tracing.py), the rays a launch
walks (all of them, or its mask's count) are added on the device to
counter `k3.rays`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sienerf_torch.ops import cuda_lib
from sienerf_torch.tracing import RECORDER

_NODE_KEYS = ("bbox_min", "bbox_max", "skip", "first_tri", "tri_count", "tri_a", "tri_ab",
              "tri_ac")


def _rows(x: torch.Tensor, n: int, name: str) -> tuple[torch.Tensor, int]:
    """(n, 3) f32 rows whose last dimension is contiguous -> (tensor, row
    stride in elements): a broadcast row keeps stride 0."""
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"bvh_walk_kernel: {name} must be (N, 3) float32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[0] != n:
        raise ValueError(f"bvh_walk_kernel: {name} has {x.shape[0]} rows, not {n}")
    if x.stride(1) != 1 or x.stride(0) not in (0, 3):
        x = x.contiguous()
    return x, x.stride(0)


def bvh_walk_kernel(bvh: dict, origins: torch.Tensor, dirs: torch.Tensor, t_max=1e10,
                    *, any_hit: bool = False, mask: torch.Tensor | None = None,
                    leaf_size: int = 4):
    """K3 on CUDA tensors.  `bvh`: the device arrays of
    TriangleBVH.as_device_arrays; origins, dirs (N, 3) f32 (a broadcast
    origin is read in place); t_max a number or (N,) f32; `mask` (N,) bool
    leaves the rays where it is False unwalked (misses).  -> closest hit
    (t (N,) inf on a miss, triangle id (N,) int64 -1 on a miss, u, v), or
    with `any_hit` (N,) bool: some triangle lies within t_max."""
    dev = origins.device
    if dev.type != "cuda":
        raise ValueError(f"bvh_walk_kernel: CUDA tensors only, got {dev}")
    n = origins.shape[0]
    o, o_stride = _rows(origins, n, "origins")
    d, d_stride = _rows(dirs, n, "dirs")
    arrays = [bvh[k] for k in _NODE_KEYS]
    for k, a in zip(_NODE_KEYS, arrays):
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"bvh_walk_kernel: bvh[{k!r}] must be contiguous on {dev}")
    t_ray = None
    if isinstance(t_max, torch.Tensor) and t_max.dim() > 0:
        t_ray = t_max.to(device=dev, dtype=torch.float32).expand(n).contiguous()
        t_all = 0.0
    else:
        t_all = float(np.float32(float(t_max)))
    m = None
    if mask is not None:
        m = mask.to(device=dev, dtype=torch.bool).reshape(n).contiguous().view(torch.uint8)
    f32 = dict(device=dev, dtype=torch.float32)
    if any_hit:
        hit = torch.empty((n,), dtype=torch.bool, device=dev)
        t = tid = u = v = None
    else:
        hit = None
        t, u, v = (torch.empty((n,), **f32) for _ in range(3))
        tid = torch.empty((n,), dtype=torch.int64, device=dev)
    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = cuda_lib.load("bvh")
    fn = lib.bvh_walk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                   + [ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_longlong, ctypes.c_float]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 6)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(*(a.data_ptr() for a in arrays), bvh["tri_a"].shape[0], o.data_ptr(),
                  o_stride, d.data_ptr(), d_stride, n, t_all, ptr(t_ray), ptr(m),
                  int(leaf_size), int(any_hit), ptr(t), ptr(tid), ptr(u), ptr(v), ptr(hit),
                  stream)
    cuda_lib.check(lib, "bvh", code)
    bvh_walk_kernel.launches += 1
    if RECORDER.on:
        RECORDER.device_counter("k3.rays", dev).add_(m.sum() if m is not None else n)
    return hit if any_hit else (t, tid, u, v)


bvh_walk_kernel.launches = 0
