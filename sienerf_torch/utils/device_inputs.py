"""Small host values on the device without a stream synchronise.

`torch.as_tensor(array, device="cuda")` copies from pageable host memory,
and PyTorch runs that copy as `cudaMemcpyAsync` followed by a synchronise
of the stream.  A frame that uploads its camera, its box corners and its
background in every spp pass therefore drains the device there, and the
host cannot queue the next pass behind the kernels.  The two functions
here make such copies without that wait:

- `upload(value, device)`, for a value that changes from call to call (a
  camera matrix): the value is staged in pinned memory from PyTorch's
  caching host allocator and copied with `non_blocking=True`.  The
  allocator records an event on the copy and hands the block out again
  only after that event, so the caller may drop or change its array at
  once.
- `constant(value, device)`, for a value that repeats (box corners, a
  background colour): a device tensor from a cache of the `CACHE_SIZE`
  most recently used, keyed on the value's exact bytes, dtype and shape
  and on the device; a miss uploads.  Callers only read the tensor; one
  written in place since it was cached is copied again.  A miss's copy is
  ordered on the stream current at the miss, the stream its readers run
  on.

Both read `value` as `torch.as_tensor` does (a tuple of floats is float32,
an array keeps its dtype) and hand back its bits.  A destination other
than a CUDA device takes plain `torch.as_tensor(value, device=...)`: on the
CPU that shares an array's memory, and nothing is pinned or cached.

Counters (always on, as the kernels' `.launches`): `upload.pinned_copies`,
the copies made from pinned memory, a miss's included; `constant.hits` and
`constant.misses`, counted for CUDA destinations only.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

CACHE_SIZE = 32

_cache: OrderedDict = OrderedDict()  # key -> (device tensor, its _version when cached)
_lock = threading.Lock()


def _from_pinned(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`host` staged in a pinned block and copied to `device` asynchronously."""
    return host.contiguous().pin_memory().to(device, non_blocking=True)


def upload(value, device) -> torch.Tensor:
    """`value` on `device` as torch.as_tensor(value, device=device) gives
    it; on a CUDA device through pinned memory, with no synchronise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.as_tensor(value, device=dev)
    upload.pinned_copies += 1
    return _from_pinned(torch.as_tensor(value), dev)


upload.pinned_copies = 0


def constant(value, device) -> torch.Tensor:
    """upload(value, device) for a value that repeats: on a CUDA device
    the cached copy of equal bytes, dtype and shape (read it, do not write
    it)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.as_tensor(value, device=dev)
    host = torch.as_tensor(value).contiguous()
    key = (host.dtype, tuple(host.shape), dev, bytes(host.reshape(-1).view(torch.uint8).numpy()))
    with _lock:
        hit = _cache.get(key)
        if hit is not None and hit[0]._version == hit[1]:
            _cache.move_to_end(key)
            constant.hits += 1
            return hit[0]
        constant.misses += 1
        t = upload(host, dev)
        _cache[key] = (t, t._version)
        _cache.move_to_end(key)
        if len(_cache) > CACHE_SIZE:
            _cache.popitem(last=False)
        return t


constant.hits = 0
constant.misses = 0
