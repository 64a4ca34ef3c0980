"""Gather probe: the random row gather rate on one NVIDIA card.

Port of the probe entry points of the JAX package's
tools/bench_pallas_gather.py (`bench`, `bench_xla`, `main`) and
tools/bench_gather.py (`bench_xla`, `bench_pallas`, `main`).  Random row
gathers are what the live renderer's hash encode and the baked renderer's
table lookups spend their time in, so the probe measures how fast the card
serves them:

  g1   G1 (ops/gather.py::gather_rows): 512-byte rows, g consecutive rows
       per index, from the (1,600,000, 128) int32 table (0.8 GB, the baked
       table regime) and from the (2^14, 128) one; N = 2^20 indices at
       g = 1, 2^18 at g = 4.
  g2   G2 (ops/gather.py::gather_small): C = 32 rows of f32 and bf16 from
       tables of T = 2^13 and 2^16 rows (small enough to stay on chip),
       N = 2^20.
  lib  `torch.index_select` alone on the same tables, as the library
       yardstick (it is also timed beside each kernel under g1 and g2).

    python3 -m sienerf_torch.tools.bench_gather [g1] [g2] [lib]

With no argument all three run.  Each kernel result is held bit for bit to
its plain version.  Times are burst times (`burst_ms`): many launches back
to back between one pair of CUDA events, queued behind a device-side wait
so that the device never waits for the host's work per call, over their
count, the median of 20 bursts.  Beside each kernel's burst time stand
`call`, the median of 20 single launches each between its own events and
followed by a synchronise (what one isolated call costs its caller, host
work included), and `trace`, the kernel's own device time in a profiler
trace of 20 calls; beside the plain version and `index_select` stands
`torch.zeros` of the output, the card's own write stream of the same
bytes.  Each line prints M rows/s, GB/s of gathered payload and the share
of the bound (the bytes this run must move to and from device memory over
the card's 3.35 TB/s; `_result` and the source note of csrc/gather.cu),
all from the burst time.  Tables stay as the caller would find them
between launches: the large one never fits the L2, the small ones are
meant to sit in it.  The probe needs the card: without one it exits
non-zero.

The originals' other variants (one-hot matmul on the MXU,
`optimization_barrier` splits, sorted-index and multi-table gathers,
`bench_isolate`) probe how XLA schedules gathers on the TPU; they have no
counterpart on this card and are not ported.
"""

from __future__ import annotations

import math
import statistics
import subprocess
import sys
import time

import torch

from sienerf_torch.ops.gather import (
    ROW_LANES,
    gather_rows,
    gather_rows_plain,
    gather_small,
    gather_small_plain,
)

HBM_BPS = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet)
# torch.cuda._sleep counts SM cycles; at most 2e6 a ms (H100 SXM boost: 1.98 GHz)
CYCLES_PER_MS = 2e6
BIG_T32 = 1_600_000  # (1.6M, 128) int32 = 0.8 GB
N_IDX = 1 << 20
G1_CASES = ((BIG_T32, N_IDX, 1), (BIG_T32, N_IDX >> 2, 4), (1 << 14, N_IDX, 1))
G2_CASES = tuple((T, 32, dt, N_IDX) for T in (1 << 13, 1 << 16)
                 for dt in (torch.float32, torch.bfloat16))


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median time of fn() in ms over `reps` single calls, each between its
    own pair of CUDA events and followed by a synchronise: the host's work
    for the call lies inside the window whenever the device is faster."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _burst(fn, n: int, lead_ms: float) -> tuple[float, float]:
    """(device ms per call, host ms per call) of n calls of fn() back to
    back between one pair of events.  A device-side wait of `lead_ms` is
    queued before the first event, so the host has queued the calls
    before the device reaches them and the device runs them without a gap
    even when the host's work per call takes longer than the kernel.  The
    n outputs stay alive until the end event has passed, so the caching
    allocator never hands a call the block that an earlier call of the
    burst is still writing."""
    outs = [None] * n
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(lead_ms * CYCLES_PER_MS))
    start.record()
    t0 = time.perf_counter()
    for i in range(n):
        outs[i] = fn()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    end.record()
    end.synchronize()
    del outs
    return start.elapsed_time(end) / n, host_ms


def burst_ms(fn, bursts: int = 20, min_burst_ms: float = 1.0,
             max_len: int = 512) -> tuple[float, int]:
    """(median device ms per call, launches a burst): fn() timed by bursts
    of L launches, L picked from a short burst so that one burst lasts at
    least `min_burst_ms` on the device (at most `max_len`, which the
    launch queue holds).  Each burst's lead covers the host's time to
    queue it, measured in that short burst.  A warm-up burst of L first
    fills the caching allocator with the blocks the timed bursts keep
    alive."""
    fn()
    torch.cuda.synchronize()
    dev, host = _burst(fn, 8, 1.0)
    n = max(1, min(max_len, math.ceil(min_burst_ms / max(dev, 1e-6))))
    lead = 0.1 + 1.5 * n * host
    _burst(fn, n, lead)
    return statistics.median(_burst(fn, n, lead)[0] for _ in range(bursts)), n


def trace_ms(fn, kernel: str, n: int = 20) -> float | None:
    """The device time of the kernels whose name holds `kernel`, per
    launch, from a profiler trace of n calls of fn(); None when the trace
    holds no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [fn() for _ in range(n)]
        torch.cuda.synchronize()
    del outs
    events = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in events)
    total_us = sum(e.self_device_time_total for e in events)
    return total_us / 1e3 / count if count and total_us > 0 else None


def make_rows_table(t32: int, device) -> torch.Tensor:
    """(t32, 128) int32 with row r, lane l holding r*131 + l, so a wrong row
    or lane shows in the value."""
    r = torch.arange(t32, dtype=torch.int32, device=device)[:, None] * 131
    return (r + torch.arange(ROW_LANES, dtype=torch.int32, device=device)[None, :]).contiguous()


def _result(name, shape, idx, n_out_rows, rows_per_idx, row_bytes, timed, plain_ms,
            library_ms, write_ms, equal) -> dict:
    """One probe line; `timed` holds the kernel's `ms` (burst), `burst_len`,
    `call_ms` and `trace_ms`; `write_ms` is the burst time of `torch.zeros`
    of the output's shape, the card's own write stream of the same bytes.
    The bound counts what this run's data needs: every distinct gathered
    row read once from device memory, every output row written once, the
    index read once, at the card's memory rate.  A row gathered twice is
    served by the L2 the second time, so `traffic_ms`, the same with every
    gathered row read (N in + N out), is what crosses the L2 and is no
    lower bound for a table that fits it."""
    n_distinct = int(torch.unique(idx).numel()) * rows_per_idx
    out_bytes = n_out_rows * row_bytes + idx.numel() * 4
    return dict(name=name, shape=shape, rows=n_out_rows, row_bytes=row_bytes, **timed,
                plain_ms=plain_ms, library_ms=library_ms, write_ms=write_ms,
                bound_ms=1e3 * (n_distinct * row_bytes + out_bytes) / HBM_BPS,
                bound_by="bytes",
                traffic_ms=1e3 * (n_out_rows * row_bytes + out_bytes) / HBM_BPS,
                equal=equal)


def time_kernel(fn, kernel: str, reps: int = 20) -> dict:
    """A kernel's burst time (`ms`, with `burst_len`), its single-call
    median (`call_ms`) and its device time in a trace (`trace_ms`)."""
    ms, n = burst_ms(fn, reps)
    return dict(ms=ms, burst_len=n, call_ms=cuda_ms(fn, reps), trace_ms=trace_ms(fn, kernel))


def bench_g1(t32: int, n: int, g: int, device, gen: torch.Generator,
             reps: int = 20) -> dict:
    """Time G1, its plain version and one index_select on the same table
    and indices, and hold the kernel's result to the plain one."""
    table = make_rows_table(t32, device)
    idx = torch.randint(0, t32 // g, (n,), generator=gen, device=device, dtype=torch.int32)
    got = gather_rows(table, idx, g)
    torch.cuda.synchronize()
    equal = torch.equal(got, gather_rows_plain(table, idx, g))
    del got
    # one library call computes the same function: rows of g*128 lanes
    wide = table[: (t32 // g) * g].view(t32 // g, g * ROW_LANES)
    timed = time_kernel(lambda: gather_rows(table, idx, g), "gather_rows", reps)
    plain_ms = burst_ms(lambda: gather_rows_plain(table, idx, g), reps)[0]
    library_ms = burst_ms(lambda: torch.index_select(wide, 0, idx), reps)[0]
    write_ms = burst_ms(lambda: torch.zeros((n, g, ROW_LANES), dtype=torch.int32,
                                            device=device), reps)[0]
    return _result("G1", f"T32={t32} ({t32 * 512 / 1e6:.1f} MB) g={g} N={n}", idx, n * g,
                   g, 512, timed, plain_ms, library_ms, write_ms, equal)


def bench_g2(t: int, c: int, dtype: torch.dtype, n: int, device,
             gen: torch.Generator, reps: int = 20) -> dict:
    """Time G2, its plain version and one index_select on the same table
    and indices, and hold the kernel's result to the plain one."""
    table = torch.randn((t, c), generator=gen, device=device, dtype=torch.float32).to(dtype)
    idx = torch.randint(0, t, (n,), generator=gen, device=device, dtype=torch.int32)
    got = gather_small(table, idx)
    torch.cuda.synchronize()
    equal = torch.equal(got, gather_small_plain(table, idx))
    del got
    timed = time_kernel(lambda: gather_small(table, idx), "gather_small", reps)
    plain_ms = burst_ms(lambda: gather_small_plain(table, idx), reps)[0]
    library_ms = burst_ms(lambda: torch.index_select(table, 0, idx), reps)[0]
    write_ms = burst_ms(lambda: torch.zeros((n, c), dtype=dtype, device=device), reps)[0]
    name = str(dtype).replace("torch.", "")
    return _result("G2", f"T={t} C={c} {name} N={n}", idx, n, 1,
                   c * table.element_size(), timed, plain_ms, library_ms, write_ms, equal)


def bench_table(name: str, table: torch.Tensor, idx: torch.Tensor, reps: int = 20) -> dict:
    """A caller's table and indices (a frame's own): G1 for an int32
    (T, 128) table of 512-byte rows, else G2; timed, held to the plain
    version and beside one index_select, as the probe's shapes are."""
    if table.dtype == torch.int32 and table.shape[1] == ROW_LANES:
        kernel, fn, plain = "gather_rows", (lambda: gather_rows(table, idx)), \
            (lambda: gather_rows_plain(table, idx))
    else:
        kernel, fn, plain = "gather_small", (lambda: gather_small(table, idx)), \
            (lambda: gather_small_plain(table, idx))
    got = fn()
    torch.cuda.synchronize()
    equal = torch.equal(got.reshape(idx.shape[0], -1), plain().reshape(idx.shape[0], -1))
    del got
    n, row_bytes = idx.shape[0], table.shape[1] * table.element_size()
    timed = time_kernel(fn, kernel, reps)
    plain_ms = burst_ms(plain, reps)[0]
    library_ms = burst_ms(lambda: torch.index_select(table, 0, idx), reps)[0]
    write_ms = burst_ms(lambda: torch.empty((n, table.shape[1]), dtype=table.dtype,
                                            device=table.device).zero_(), reps)[0]
    shape = (f"T={table.shape[0]} ({table.shape[0] * row_bytes / 1e9:.2f} GB) "
             f"{row_bytes}-byte rows N={n}")
    return _result(name, shape, idx, n, 1, row_bytes, timed, plain_ms, library_ms, write_ms,
                   equal)


def format_result(r: dict) -> str:
    rate = r["rows"] / (r["ms"] * 1e-3)
    trace = "not measured" if r["trace_ms"] is None else f"{r['trace_ms']:.4f} ms"
    return (f"{r['name']} {r['shape']}: kernel {r['ms']:.4f} ms (bursts of "
            f"{r['burst_len']}; call {r['call_ms']:.4f} ms, trace {trace})  "
            f"{rate / 1e6:8.1f} M rows/s  {rate * r['row_bytes'] / 1e9:7.1f} GB/s  "
            f"bound {r['bound_ms']:.4f} ms ({100 * r['bound_ms'] / r['ms']:.1f} % of it; "
            f"all rows through L2 {r['traffic_ms']:.4f} ms)  plain {r['plain_ms']:.4f} ms  "
            f"index_select {r['library_ms']:.4f} ms  zeros of the output "
            f"{r['write_ms']:.4f} ms  equal={r['equal']}")


def bench_lib(t: int, c: int, dtype: torch.dtype, n: int, device,
              gen: torch.Generator, reps: int = 20) -> str:
    """`torch.index_select` of n random rows of a (t, c) table, alone."""
    table = torch.zeros((t, c), device=device, dtype=dtype)
    idx = torch.randint(0, t, (n,), generator=gen, device=device, dtype=torch.int32)
    ms = burst_ms(lambda: torch.index_select(table, 0, idx), reps)[0]
    row_bytes = c * table.element_size()
    rate = n / (ms * 1e-3)
    name = str(dtype).replace("torch.", "")
    return (f"lib index_select T={t} C={c} {name} ({t * row_bytes / 1e6:.1f} MB) N={n}: "
            f"{ms:.4f} ms  {rate / 1e6:8.1f} M rows/s  {rate * row_bytes / 1e9:7.1f} GB/s")


def run(which: set[str], device, reps: int = 20, out=print) -> list[dict]:
    """Run the named variants on `device`, print one line each through
    `out`, and return the kernels' results (one dict per G1 / G2 shape)."""
    gen = torch.Generator(device=device).manual_seed(0)
    results = []
    if "g1" in which:
        results += [bench_g1(t32, n, g, device, gen, reps) for t32, n, g in G1_CASES]
    if "g2" in which:
        results += [bench_g2(t, c, dtype, n, device, gen, reps)
                    for t, c, dtype, n in G2_CASES]
    for r in results:
        out(format_result(r))
    if "lib" in which:
        out(bench_lib(BIG_T32, ROW_LANES, torch.int32, N_IDX, device, gen, reps))
        out(bench_lib(1 << 14, ROW_LANES, torch.int32, N_IDX, device, gen, reps))
        for t, c, dtype, n in G2_CASES:
            out(bench_lib(t, c, dtype, n, device, gen, reps))
    return results


def main(argv: list[str]) -> int:
    which = set(argv) or {"g1", "g2", "lib"}
    unknown = which - {"g1", "g2", "lib"}
    if unknown:
        print(f"bench_gather: unknown variant {sorted(unknown)}; use g1, g2, lib",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bench_gather: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    results = run(which, torch.device("cuda"), out=lambda line: print(line, flush=True))
    if not all(r["equal"] for r in results):
        print("bench_gather: a kernel result differs from its plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
