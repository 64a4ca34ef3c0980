"""The metric arithmetic on synthetic data: the window's frame time and its
p95 over all frames, the bounds and flops from shapes, the idle share and
the per-layer readers on a synthetic event list."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import peaks, spec
from perfbench.kinds.video import window_metrics
from perfbench.trace import idle_gaps, top_ops, union_ns
from perfbench.weights import network_dims

MS = 1_000_000  # ns


def test_frame_ms_is_the_window_over_all_frames_and_p95_is_of_all_frames():
    times = [0.010] * 95 + [0.100] * 5
    m = window_metrics(times, window_s=2.0)
    assert m["frame_ms"] == pytest.approx(20.0)  # the window, not the mean frame time
    assert m["frame_p95_ms"] == pytest.approx(1e3 * np.percentile(times, 95))
    m = window_metrics([0.010] * 90 + [0.100] * 10, window_s=1.9)
    assert m["frame_p95_ms"] == pytest.approx(100.0)


@pytest.mark.parametrize("config,flops", [("base84", 12_672), ("big", 41_728)])
def test_colour_mlp_flops_at_the_published_widths(config, flops):
    bench = spec.load_benchmark()
    dims = network_dims(spec.load_config(bench, config))
    assert peaks.mlp_flops(dims["rgb_mlp"]) == flops


def test_k1_bound_of_the_fox_bake():
    # 3 x 257^3 vertices, 26,701,680 kept: 1.310 GB at 3.35 TB/s
    rows = 3 * 257 ** 3
    dims = [(32, 64), (64, 64), (64, 3)]
    b = peaks.k1_bound_s(rows, 26_701_680, 3, 256, dims, 48)
    nbytes = 26_701_680 * 32 + (rows - 26_701_680) * 2 + rows * 8 + 48 * 4 + 12 + 6336 * 2
    assert b == pytest.approx(nbytes / peaks.HBM_BYTES_S)
    assert 0.38e-3 < b < 0.40e-3
    big = [(32, 128), (128, 128), (128, 3)]  # operations bound it
    assert peaks.k1_bound_s(rows, 26_701_680, 3, 256, big, 48) == pytest.approx(
        26_701_680 * 41_728 / peaks.BF16_FLOPS)


def test_k2_bound_takes_the_larger_of_bytes_and_operations():
    few = peaks.k2_bound_s(1000, 10 ** 8, 3, 256, 1280, 2304)
    assert few == pytest.approx((10 ** 8 * 8 + 3 * 256 * 20 + 3584 * 4 + 1280 * 2304 * 24)
                                / peaks.HBM_BYTES_S)
    many = peaks.k2_bound_s(10 ** 11, 0, 3, 256, 1280, 2304)
    assert many == pytest.approx(10 ** 11 * 30 / peaks.F32_FLOPS)


EVENTS = [  # (name, start ns, duration ns): two frames of spp 2
    ("void shade_kernel<1>(short const*)", 0, 2 * MS),
    ("sweep_kernel", 2 * MS, 1 * MS),
    ("elementwise", 3 * MS, 1 * MS),
    ("shade_kernel", 5 * MS, 2 * MS),
    ("sweep_kernel", 7 * MS, 3 * MS),
    ("Memcpy DtoH (Device -> Pageable)", 9 * MS, 2 * MS),  # overlaps the sweep
    ("shade_general_kernel<64, 3, 12>", 20 * MS, 2 * MS),
    ("sweep_kernel", 22 * MS, 1 * MS),
    ("shade_general_kernel<64, 3, 12>", 23 * MS, 2 * MS),
    ("sweep_kernel", 25 * MS, 1 * MS),
]


def test_union_idle_and_breakdown():
    assert union_ns(EVENTS) == 4 * MS + 6 * MS + 6 * MS
    ops = top_ops(EVENTS)
    assert ops[0][1] == pytest.approx(6e-3) and len(ops) <= 10
    gaps = idle_gaps(EVENTS, lambda i: f"before {i}")
    assert gaps[0] == ["before 6", pytest.approx(9e-3)]
    assert gaps[1] == ["before 3", pytest.approx(1e-3)]


def _ctx(**kw):
    ctx = {"events": EVENTS, "window_s": 0.040, "spans": {"bake": 1.5},
           "format": {"spp": 2, "width": 64, "height": 36},
           "counts": {"frames": 2, "k2_launches": 4, "kept_rows": 1000, "rows": 3 * 17 ** 3,
                      "n_cascades": 3, "resolution": 16, "n_scales": 48},
           "rgb_dims": [(32, 64), (64, 64), (64, 3)],
           "k2_stats": {5: [{"samples": 10 ** 8, "texels": 0}] * 2}, "frame_index": {5: 1}}
    ctx.update(kw)
    return ctx


def read(name, ctx):
    return spec.metric_reader(name)(ctx)


def test_idle_and_rest_readers():
    assert read("idle_pct.video", _ctx()) == pytest.approx(100 * (1 - 16 / 40))
    assert read("rest_device_ms.video", _ctx()) == pytest.approx((1 + 2) / 2)
    assert read("bake_s", _ctx()) == 1.5


def test_k1_and_mfu_readers():
    c = _ctx()["counts"]
    bound = peaks.k1_bound_s(c["rows"], 1000, 3, 16, _ctx()["rgb_dims"], 48)
    assert read("k1_roofline", _ctx()) == pytest.approx(100 * bound * 4 / 8e-3)
    assert read("mfu_pct.video", _ctx()) == pytest.approx(
        100 * 1000 * 12_672 * 2 * 2 / (0.040 * peaks.BF16_FLOPS))


def test_k2_reader_takes_the_checked_frames_launches():
    bound = 2 * peaks.k2_bound_s(10 ** 8, 0, 3, 16, 128, 128)
    # frame 1's K2 launches are the third and fourth: 1 + 1 ms
    assert read("k2_roofline", _ctx()) == pytest.approx(100 * bound / 2e-3)
    # a window whose K2 launches are not spp a frame reads nothing
    assert read("k2_roofline", _ctx(counts=dict(_ctx()["counts"], k2_launches=5))) is None


@pytest.mark.parametrize("name", ["k1_roofline", "k2_roofline", "rest_device_ms.video",
                                  "mfu_pct.video", "idle_pct.video"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert read(name, _ctx(events=None)) is None
