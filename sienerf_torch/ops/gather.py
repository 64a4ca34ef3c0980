"""G1 and G2, the random row gathers of the gather probe: CUDA kernel
wrappers and their plain PyTorch versions.

Ports of the two Pallas kernels in the JAX package's tools:
tools/bench_pallas_gather.py::gather_rows_pallas (G1, wide 512-byte rows
from a table far larger than any cache) and the kernel inside
tools/bench_gather.py::bench_pallas (G2, narrow rows from a table held on
chip).  Both are the random row gather that the renderers' hash encode and
baked-table lookups issue.  The kernels are `csrc/gather.cu`; its source
note gives the designs and the bounds.  A gather copies bits, so each
kernel equals its plain version exactly.

The library calls that compute the same function (`index_select`, advanced
indexing) appear here only as the plain versions: the CUDA branch of a
wrapper launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from sienerf_torch.ops import cuda_lib

ROW_LANES = 128  # G1's row: 128 int32 = 512 bytes
# the launch functions' C signature: table, idx, out, n_idx, g or units,
# t_rows, the device's SM count, stream
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p])
_bound: dict[str, tuple] = {}  # launch function name -> (library, bound function)
_sms: dict[int, int] = {}  # device index -> SM count


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor, g: int = 1) -> torch.Tensor:
    """Plain G1: table (T32, 128) int32, idx (N,) in [0, T32 // g) ->
    (N, g, 128), out[i, j] = table[idx[i] * g + j]."""
    rows = idx.to(torch.int64)[:, None] * g + torch.arange(g, device=idx.device)
    return table.index_select(0, rows.reshape(-1)).reshape(idx.shape[0], g, table.shape[1])


def gather_small_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain G2: table (T, C), idx (N,) in [0, T) -> (N, C)."""
    return table.index_select(0, idx.to(torch.int64))


def _check_idx(name: str, table: torch.Tensor, idx: torch.Tensor) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError(f"{name}: idx must be contiguous int32 (N,), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != table.device:
        raise ValueError(f"{name}: idx on {idx.device}, table on {table.device}")
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the table must start on a 16-byte boundary")
    if table.shape[0] == 0 and idx.shape[0] > 0:
        raise ValueError(f"{name}: {idx.shape[0]} indices into an empty table")


def _function(fn_name: str):
    """(library, launch function), its argument types set once for each
    loaded library.  The library is asked for on every call, so a failed
    build raises on every call."""
    lib = cuda_lib.load("gather")
    got = _bound.get(fn_name)
    if got is None or got[0] is not lib:
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
        got = _bound[fn_name] = (lib, fn)
    return got


def _launch(fn_name: str, table, idx, out, n_idx: int, arg: int, t_rows: int) -> None:
    lib, fn = _function(fn_name)
    dev = table.device.index
    sms = _sms.get(dev)
    if sms is None:
        sms = _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), n_idx, arg, t_rows, sms)
    if dev == torch.cuda.current_device():
        code = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            code = fn(*args, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(lib, "gather", code)


def gather_rows(table: torch.Tensor, idx: torch.Tensor, g: int = 1) -> torch.Tensor:
    """G1: table (T32, 128) int32, idx (N,) int32 in [0, T32 // g) ->
    (N, g, 128) int32 with out[i, j] = table[idx[i] * g + j]: g consecutive
    512-byte rows per index.

    The JAX function also takes `block` and `window`; they size the TPU
    kernel's DMA pipeline (rows per grid step, copies in flight) and do not
    change the result, so they are not arguments here, and N need not be a
    multiple of anything.  Launches the CUDA kernel for CUDA tensors;
    tensors on the CPU take the plain version.  On the card an index out of
    range trips a device-side assert."""
    if g < 1:
        raise ValueError(f"gather_rows: g must be >= 1, got {g}")
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[1] != ROW_LANES:
        raise ValueError(f"gather_rows: table must be int32 (T32, {ROW_LANES}), got "
                         f"{table.dtype} {tuple(table.shape)}")
    _check_idx("gather_rows", table, idx)
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx, g)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    n = idx.shape[0]
    out = torch.empty((n, g, ROW_LANES), dtype=torch.int32, device=table.device)
    _launch("gather_rows512_launch", table, idx, out, n, g, table.shape[0])
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_small(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """G2: table (T, C) of any dtype whose rows are a multiple of 16 bytes,
    starting on a 16-byte boundary, idx (N,) int32 in [0, T) -> (N, C) with
    out[i] = table[idx[i]].  Meant for tables that fit the card's L2 (the
    TPU kernel holds the table in VMEM); larger tables work and run at HBM
    speed.  Launches the CUDA kernel for CUDA tensors; tensors on the CPU
    take the plain version.  On the card an index out of range trips a
    device-side assert."""
    if table.dim() != 2:
        raise ValueError(f"gather_small: table must be (T, C), got {tuple(table.shape)}")
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes == 0 or row_bytes % 16:
        raise ValueError(f"gather_small: rows must be a multiple of 16 bytes, got "
                         f"{row_bytes} ({table.dtype} x {table.shape[1]})")
    _check_idx("gather_small", table, idx)
    if table.device.type == "cpu":
        return gather_small_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_small: unsupported device {table.device}")
    n = idx.shape[0]
    out = torch.empty((n, table.shape[1]), dtype=table.dtype, device=table.device)
    _launch("gather_small_launch", table, idx, out, n, row_bytes // 16, table.shape[0])
    gather_small.launches += 1
    return out


gather_small.launches = 0
