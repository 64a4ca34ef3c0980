"""G1 and G2 (the gather probe's kernels): the port's plain versions against
the JAX package's Pallas kernel in interpret mode and against `jnp.take`,
bit for bit (a gather copies bits: tolerance 0).

G1's Pallas kernel runs in interpret mode at the sizes of its own
`main --interpret` (T32 = 4096, N = 1024, g in {1, 2}, window 8).  G2's
Pallas body cannot run in interpret mode as written (a VMEM-resident table
spec inside a function that also times); its whole body is
`jnp.take(table, idx, axis=0)`, so the plain version is held to that.

On the CPU a wrapper takes its plain version; on a CUDA tensor it launches
the kernel, which tests/test_torch_kernels.py holds to the plain version on
the card."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sienerf_torch.ops.gather import (
    gather_rows,
    gather_rows_plain,
    gather_small,
    gather_small_plain,
)

TOOLS = Path(__file__).resolve().parent.parent / "tools"


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_probe():
    """tools/bench_pallas_gather.py, imported by path (tools/ is no package)."""
    spec = importlib.util.spec_from_file_location(
        "bench_pallas_gather", TOOLS / "bench_pallas_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _g1_inputs(t32, n, g, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.integers(-2 ** 31, 2 ** 31, (t32, 128), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, t32 // g, n).astype(np.int32)
    return table, idx


@pytest.mark.parametrize("g", [1, 2])
def test_g1_plain_matches_pallas_interpret(jax_probe, g):
    table, idx = _g1_inputs(1 << 12, 1 << 10, g)
    want = np.asarray(jax_probe.gather_rows_pallas(
        jnp.asarray(table), jnp.asarray(idx), block=1024, window=8, g=g, interpret=True))
    got = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx), g)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1 << 10, g, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(gather_rows(torch.from_numpy(table), torch.from_numpy(idx), g), got)


@pytest.mark.parametrize("g", [1, 3, 4])
def test_g1_plain_matches_take(jax_probe, g):
    """Against the probe's own check (`jnp.take` of rows idx*g + j), on the
    probe's table (row r, lane l = r*131 + l), N not a multiple of 1024."""
    t32, n = 3000, 777
    idx = np.random.default_rng(g).integers(0, t32 // g, n).astype(np.int32)
    jt = jax_probe._make_table(t32)
    want = np.stack([np.asarray(jnp.take(jt, jnp.asarray(idx) * g + j, axis=0))
                     for j in range(g)], axis=1)
    from sienerf_torch.tools.bench_gather import make_rows_table

    table = make_rows_table(t32, "cpu")
    np.testing.assert_array_equal(table.numpy(), np.asarray(jt))
    got = gather_rows(table, torch.from_numpy(idx), g)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("log2_t", [13, 16])
def test_g2_plain_matches_take(dtype, log2_t):
    rng = np.random.default_rng(log2_t)
    t, c, n = 1 << log2_t, 32, 1 << 12
    table = rng.normal(size=(t, c)).astype(np.float32)
    idx = rng.integers(0, t, n).astype(np.int32)
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    tt = torch.from_numpy(table).to(getattr(torch, dtype))
    want = jnp.take(jt, jnp.asarray(idx), axis=0)
    got = gather_small(tt, torch.from_numpy(idx))
    assert got.dtype == tt.dtype and tuple(got.shape) == (n, c)
    # compare the bits: f32 as they are, bf16 widened exactly
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert torch.equal(got, gather_small_plain(tt, torch.from_numpy(idx)))


@pytest.mark.parametrize("bad", ["idx_dtype", "table_dtype", "table_width", "g",
                                 "row_bytes", "idx_rank"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    table, idx = _g1_inputs(64, 16, 1)
    table, idx = torch.from_numpy(table), torch.from_numpy(idx)
    with pytest.raises(ValueError):
        if bad == "idx_dtype":
            gather_rows(table, idx.long())
        elif bad == "table_dtype":
            gather_rows(table.float(), idx)
        elif bad == "table_width":
            gather_rows(table[:, :64].contiguous(), idx)
        elif bad == "g":
            gather_rows(table, idx, 0)
        elif bad == "row_bytes":
            gather_small(torch.zeros((8, 3)), idx % 8)
        else:
            gather_small(torch.zeros((8, 4)), (idx % 8)[None])


def test_launch_counts_stay_zero_on_cpu():
    table, idx = _g1_inputs(64, 16, 1)
    before = (gather_rows.launches, gather_small.launches)
    gather_rows(torch.from_numpy(table), torch.from_numpy(idx))
    gather_small(torch.zeros((64, 4)), torch.from_numpy(idx))
    assert (gather_rows.launches, gather_small.launches) == before


# --- the probe's arithmetic and the wrappers' checks (no card needed) --------


@pytest.mark.parametrize("name,g,row_bytes", [("G1", 1, 512), ("G1", 2, 512),
                                              ("G2", 1, 64), ("G2", 1, 128)])
def test_probe_bound_counts_distinct_rows(name, g, row_bytes):
    """bench_gather._result on a hand-made idx: 6 indices, 4 distinct."""
    from sienerf_torch.tools.bench_gather import HBM_BPS, _result

    idx = torch.tensor([0, 3, 3, 5, 0, 7], dtype=torch.int32)
    timed = dict(ms=0.5, burst_len=4, call_ms=0.75, trace_ms=None)
    r = _result(name, "hand-made", idx, 6 * g, g, row_bytes, timed, 1.0, 2.0, 0.25, True)
    distinct_bytes = 4 * g * row_bytes
    out_bytes = 6 * g * row_bytes + 6 * 4
    assert r["rows"] == 6 * g and r["row_bytes"] == row_bytes and r["bound_by"] == "bytes"
    assert r["bound_ms"] == pytest.approx(1e3 * (distinct_bytes + out_bytes) / HBM_BPS,
                                          rel=1e-12)
    assert r["traffic_ms"] == pytest.approx(1e3 * (6 * g * row_bytes + out_bytes) / HBM_BPS,
                                            rel=1e-12)
    assert r["traffic_ms"] > r["bound_ms"]
    assert (r["ms"], r["burst_len"], r["call_ms"], r["trace_ms"]) == (0.5, 4, 0.75, None)
    assert (r["plain_ms"], r["library_ms"], r["write_ms"], r["equal"]) == (1.0, 2.0, 0.25, True)


@pytest.mark.parametrize("per_call_ms,want_len", [(0.03, 34), (0.4, 3), (2.5, 1),
                                                  (1e-5, 512)])
def test_burst_length_lasts_the_minimum(monkeypatch, per_call_ms, want_len):
    """A burst holds enough launches to last 1 ms on the device, at least
    one and at most 512; its lead covers the host's time to queue it; the
    result is the median of the timed bursts."""
    from sienerf_torch.tools import bench_gather

    calls = []
    host_ms = 0.02

    def fake_burst(fn, n, lead_ms):
        calls.append((n, lead_ms))
        return per_call_ms * (1.0 + 0.01 * len(calls)), host_ms

    monkeypatch.setattr(bench_gather, "_burst", fake_burst)
    monkeypatch.setattr(bench_gather.torch.cuda, "synchronize", lambda: None)
    ms, n = bench_gather.burst_ms(lambda: None, bursts=5)
    assert n == want_len
    lead = 0.1 + 1.5 * want_len * host_ms
    assert calls == [(8, 1.0)] + [(want_len, lead)] * 6  # sizing, warm-up, five timed
    assert ms == pytest.approx(per_call_ms * (1.0 + 0.01 * 5))  # the median of calls 3-7


@pytest.mark.parametrize("case", ["small_misaligned", "rows_misaligned", "small_empty",
                                  "rows_empty"])
def test_wrappers_reject_misaligned_and_empty_tables(case):
    """A table that does not start on a 16-byte boundary, and indices into
    an empty table, are refused on every device, before any launch."""
    idx = torch.zeros(4, dtype=torch.int32)
    before = (gather_rows.launches, gather_small.launches)
    with pytest.raises(ValueError, match="16-byte boundary|empty table"):
        if case == "small_misaligned":
            raw = torch.zeros(17 * 16, dtype=torch.uint8)
            table = raw[1:257].view(16, 16)  # rows of 16 bytes, one byte in
            assert table.is_contiguous() and table.data_ptr() % 16
            gather_small(table, idx)
        elif case == "rows_misaligned":
            raw = torch.zeros(3 * 128 + 1, dtype=torch.int32)
            table = raw[1:].view(3, 128)  # one int32 in
            assert table.is_contiguous() and table.data_ptr() % 16
            gather_rows(table, idx % 3)
        elif case == "small_empty":
            gather_small(torch.zeros((0, 8)), idx)
        else:
            gather_rows(torch.zeros((0, 128), dtype=torch.int32), idx)
    assert (gather_rows.launches, gather_small.launches) == before


def test_wrappers_take_no_indices_into_an_empty_table():
    idx = torch.zeros(0, dtype=torch.int32)
    assert tuple(gather_small(torch.zeros((0, 8)), idx).shape) == (0, 8)
    assert tuple(gather_rows(torch.zeros((0, 128), dtype=torch.int32), idx).shape) == (0, 1, 128)
