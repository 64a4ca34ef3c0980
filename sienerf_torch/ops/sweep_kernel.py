"""K2, the fused slab-sweep composite: CUDA kernel wrapper.

Port of the JAX package's ops/sweep_pallas.py::sweep_composite_pallas.  The
kernel is `csrc/sweep.cu` (one thread per intermediate pixel, a loop over
the slabs of the pixel's live intervals, the carry in registers, a texel of
channel-last storage as one 8-byte load; its source note gives the design
and the bound).  The plain version is ops/sweep.py::sweep_composite, and
ops/sweep.py::slab_intervals is the plain version of the kernel's intervals.

`sweep_composite_sharded` splits the slab schedule over the ranks of a mesh
(parallel/mesh.py): each rank composites its contiguous share through K2
and the ranks' partials are folded in schedule order
(ops/sweep.py::fold_partials).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sienerf_torch.ops import cuda_lib
from sienerf_torch.ops.sweep import fold_partials, slab_schedule, sweep_composite
from sienerf_torch.parallel.mesh import all_gather, shard_range
from sienerf_torch.tracing import RECORDER

_INTERPS = ("nearest", "bilinear")


@functools.lru_cache(maxsize=8)
def _device_schedule(n_cascades: int, resolution: int, device: torch.device) -> torch.Tensor:
    """slab_schedule as the kernel reads it: (S, 5) f32 rows of cascade,
    slab, x, pitch, inner flag, on `device`, built once per shape."""
    casc, slab, xs, pitch, inner = slab_schedule(n_cascades, resolution)
    return torch.as_tensor(np.stack(
        [casc.astype(np.float32), slab.astype(np.float32), xs, pitch,
         inner.astype(np.float32)], axis=1), device=device).contiguous()


def sweep_composite_plain(volume, o_c, eb, ec, near, min_transmittance,
                          t_stop=None, phase=None, *, resolution: int,
                          n_cascades: int, interp: str = "nearest",
                          data_flip: bool = False, schedule=None, return_bw: bool = False):
    """The plain version with the kernel's interface: `data_flip` reads data
    plane R-j for canonical slab j, i.e. sweeps the volume flipped."""
    oriented = volume.flip(1) if data_flip else volume
    return sweep_composite(oriented, o_c, eb, ec, near, min_transmittance,
                           t_stop, phase, resolution=resolution,
                           n_cascades=n_cascades, interp=interp, schedule=schedule,
                           return_bw=return_bw)


def sweep_composite_kernel(volume, o_c, eb, ec, near, min_transmittance,
                           t_stop=None, phase=None, *, resolution: int,
                           n_cascades: int, interp: str = "nearest",
                           data_flip: bool = False, schedule=None, return_bw: bool = False):
    """K2: composite every slab of slab_schedule front to back (with
    `schedule` = (s0, s1) the schedule's entries [s0, s1) only, from
    T = 1).

    volume: (K, R+1, 4, R+1, R+1) bf16 [s*r, s*g, s*b, s] in sweep order,
    any strides (a permuted view of the shade kernel's channel-last
    storage reads a texel as one 8-byte load; any other channel stride
    takes the kernel's generic path);
    o_c (3,) canonical camera origin; eb (Hi,), ec (Wi,) gnomonic
    coordinates; t_stop optional (Hi, Wi) per-pixel t cap; phase optional
    slab-phase jitter in [0, 1) -> (rgb (Hi, Wi, 3), opacity, T,
    depth_t (Hi, Wi)), all f32, and the best weight (Hi, Wi) last with
    `return_bw`.  Launches the CUDA kernel for CUDA tensors; tensors on the
    CPU take the plain version.  While the recorder records (tracing.py)
    the counting variant adds the samples it composites to device counter
    `k2.live_samples`."""
    if interp not in _INTERPS:
        raise ValueError(f"sweep_composite_kernel: unknown interp {interp!r}")
    kw = dict(resolution=resolution, n_cascades=n_cascades, interp=interp,
              data_flip=data_flip, schedule=schedule, return_bw=return_bw)
    if volume.device.type == "cpu":
        return sweep_composite_plain(volume, o_c, eb, ec, near, min_transmittance,
                                     t_stop, phase, **kw)
    if volume.device.type != "cuda":
        raise ValueError(f"sweep_composite_kernel: unsupported device {volume.device}")
    R, K = resolution, n_cascades
    Rv = R + 1
    dev = volume.device
    if volume.dtype != torch.bfloat16 or tuple(volume.shape) != (K, Rv, 4, Rv, Rv):
        raise ValueError(f"sweep_composite_kernel: volume must be bf16 "
                         f"({K}, {Rv}, 4, {Rv}, {Rv}), got {volume.dtype} "
                         f"{tuple(volume.shape)}")
    # channel-last: the 4 channels of a texel are 8 contiguous, aligned bytes
    strides = volume.stride()
    channel_last = (strides[2] == 1 and volume.data_ptr() % 8 == 0
                    and all(s % 4 == 0 for i, s in enumerate(strides) if i != 2))
    f32 = dict(device=dev, dtype=torch.float32)
    o_c = o_c.to(**f32).contiguous()
    eb = eb.to(**f32).contiguous()
    ec = ec.to(**f32).contiguous()
    Hi, Wi = eb.shape[0], ec.shape[0]
    if t_stop is not None:
        t_stop = t_stop.to(**f32).contiguous()
        if tuple(t_stop.shape) != (Hi, Wi):
            raise ValueError(f"sweep_composite_kernel: t_stop must be ({Hi}, {Wi})")
    sched = _device_schedule(K, R, dev)
    if schedule is not None:
        s0, s1 = int(schedule[0]), int(schedule[1])
        if not 0 <= s0 <= s1 <= sched.shape[0]:
            raise ValueError(f"sweep_composite_kernel: schedule must be a range in "
                             f"[0, {sched.shape[0]}], got {schedule}")
        sched = sched[s0:s1]
    C = torch.empty((Hi, Wi, 3), **f32)
    op = torch.empty((Hi, Wi), **f32)
    T = torch.empty((Hi, Wi), **f32)
    bt = torch.empty((Hi, Wi), **f32)
    bw = torch.empty((Hi, Wi), **f32) if return_bw else None
    live = RECORDER.device_counter("k2.live_samples", dev) if RECORDER.on else None

    lib = cuda_lib.load("sweep")
    fn = lib.sweep_composite_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 5 + [ctypes.c_int]
        + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
        + [ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 2
        + [ctypes.c_void_p] * 7)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(volume.data_ptr(), *strides, int(channel_last),
                  sched.data_ptr(), sched.shape[0], K, o_c.data_ptr(),
                  eb.data_ptr(), ec.data_ptr(),
                  None if t_stop is None else t_stop.data_ptr(),
                  Hi, Wi, R, float(np.float32(near)),
                  float(np.float32(min_transmittance)),
                  int(phase is not None),
                  float(np.float32(0.0 if phase is None else phase)),
                  int(interp != "nearest"), int(data_flip),
                  C.data_ptr(), op.data_ptr(), T.data_ptr(), bt.data_ptr(),
                  None if bw is None else bw.data_ptr(),
                  None if live is None else live.data_ptr(), stream)
    cuda_lib.check(lib, "sweep", code)
    sweep_composite_kernel.launches += 1
    return (C, op, T, bt, bw) if return_bw else (C, op, T, bt)


sweep_composite_kernel.launches = 0


def sweep_composite_sharded(mesh, volume, o_c, eb, ec, near, min_transmittance, *,
                            resolution: int, n_cascades: int, interp: str = "nearest",
                            data_flip: bool = False):
    """The slab-range-parallel sweep over a mesh's ranks (the volume the
    same on every rank): rank r composites its shard_range share of the
    K*R entries of slab_schedule through K2 (sweep_composite_kernel, the
    plain version on the CPU) from T = 1, so that the min-transmittance
    cutoff is each share's own, as in the JAX package; the partials
    (C, op, T, bw, bt) are gathered in rank order and folded
    (ops/sweep.py::fold_partials) -> (rgb (Hi, Wi, 3), opacity, T,
    depth_t (Hi, Wi)) on every rank."""
    s0, s1 = shard_range(n_cascades * resolution, mesh.world, mesh.rank)
    C, op, T, bt, bw = sweep_composite_kernel(
        volume, o_c, eb, ec, near, min_transmittance, resolution=resolution,
        n_cascades=n_cascades, interp=interp, data_flip=data_flip, schedule=(s0, s1),
        return_bw=True)
    local = torch.cat([C, op[..., None], T[..., None], bw[..., None], bt[..., None]], dim=-1)
    parts = [(p[..., :3], p[..., 3], p[..., 4], p[..., 5], p[..., 6])
             for p in all_gather(local, mesh)]
    return fold_partials(parts)
