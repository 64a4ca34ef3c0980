"""The recorder of sienerf_torch/tracing.py: off it records nothing; under
torch.profiler a sweep frame of `Session.render` records its spans with the
right parents and one frame id; self time, the bound, a new recording, the
phase clock's spans.  Tests marked `cuda` hold it to the card's device
trace: the profiler's CUDA-only session turns it on, its clock is the
trace's, it leaves the traced events as they were, and K2's live-sample
counter equals the plain composite's count.

This file imports no JAX, so on the card it runs without the repo's
conftest:  python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_tracing.py
"""

from __future__ import annotations

import re
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.generator import fibonacci_cameras
from sienerf_torch import tracing
from sienerf_torch.session import Session
from sienerf_torch.tracing import NOOP, PhaseClock, Recorder, Recording, Span

FOX = Path(__file__).resolve().parent.parent / "data" / "fox_render.snap"
PASS_CHILDREN = ["geometry", "shade", "composite", "warp", "accumulate"]
SPAN_NAMES = {"render", "pass", *PASS_CHILDREN}
CLOCK_TOLERANCE_NS = 50_000  # the clock test's allowance between host spans and device events


def _cam(k: int = 3) -> np.ndarray:
    """Camera k of the video cells' orbit about the fox."""
    return fibonacci_cameras(120, 1.8)[k]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fox_cpu():
    s = Session(device="cpu")
    s.load_snapshot(FOX)
    s.bake(resolution=16)
    return s


def _cpu_frame(s: Session, spp: int = 2):
    return s.render(32, 18, _cam(), focal=(30.0, 30.0), spp=spp, renderer="sweep")


def _children(rec: Recording, i: int) -> list:
    return [k for k, s in enumerate(rec.spans) if s.parent == i]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return tracing.RECORDER.read()


# --- off ---------------------------------------------------------------------


@pytest.mark.parametrize("what", ["recorder", "frame"])
def test_off_records_nothing_and_touches_no_counter(fox_cpu, what):
    if what == "recorder":
        rec = Recorder()
        assert rec.frame("render") is NOOP and rec.span("pass", device=True) is NOOP
        with rec.frame("render"):
            with rec.span("pass", device=True):
                pass
        got = rec.read()
        assert got.spans == [] and got.counters == {} and got.dropped == 0
    else:
        before = tracing.RECORDER.read()
        counters = dict(before.counters)
        _cpu_frame(fox_cpu)
        assert tracing.RECORDER.read() is before  # no recording began
        assert before.counters == counters
    assert tracing.RECORDER.on is False


# --- on: the sweep frame -----------------------------------------------------


def test_a_traced_sweep_frame_records_its_spans(fox_cpu):
    rec = _traced(lambda: _cpu_frame(fox_cpu, spp=2))
    names = [s.name for s in rec.spans]
    assert names == ["render"] + ["pass"] + PASS_CHILDREN + ["pass"] + PASS_CHILDREN
    assert {s.frame for s in rec.spans} == {0}
    assert rec.spans[0].parent == -1
    passes = [i for i, s in enumerate(rec.spans) if s.name == "pass"]
    for p in passes:
        assert rec.spans[p].parent == 0
        kids = _children(rec, p)
        assert [rec.spans[k].name for k in kids] == PASS_CHILDREN
        t = rec.spans[p].start_ns
        for k in kids:  # in order, inside the pass
            s = rec.spans[k]
            assert t <= s.start_ns <= s.end_ns <= rec.spans[p].end_ns
            t = s.end_ns
    assert all(s.device is None for s in rec.spans)  # no card: host spans only
    assert rec.dropped == 0 and tracing.RECORDER.on is False


def test_frames_number_from_zero_and_a_second_recording_clears_the_first(fox_cpu):
    first = _traced(lambda: [_cpu_frame(fox_cpu, spp=1) for _ in range(2)])
    assert [s.frame for s in first.named("render")] == [0, 1]
    second = _traced(lambda: _cpu_frame(fox_cpu, spp=1))
    assert [s.name for s in second.spans] == ["render", "pass"] + PASS_CHILDREN
    assert {s.frame for s in second.spans} == {0}
    assert tracing.RECORDER.read() is second  # reading again changes nothing


# --- self time, the bound, the phase clock -------------------------------------


def _span(name, parent, a, b):
    return Span(name, parent, 0, a, b, None)


@pytest.mark.parametrize("kids,covered", [
    ([], 0),
    ([(10, 20), (30, 45)], 25),           # apart
    ([(10, 30), (20, 40)], 30),           # overlapping: counted once
    ([(10, 30), (30, 40), (35, 38)], 30),  # touching, and one inside another
])
def test_self_time_is_the_duration_less_what_the_children_cover(kids, covered):
    spans = [_span("p", -1, 0, 100)] + [_span("c", 0, a, b) for a, b in kids]
    assert Recording(spans).self_ns(0) == 100 - covered


def test_idle_time_goes_to_the_innermost_span():
    # render 0-100 > pass 10-90 > composite 20-50, warp 60-70; a second render 200-300
    spans = [_span("render", -1, 0, 100), _span("pass", 0, 10, 90),
             _span("composite", 1, 20, 50), _span("warp", 1, 60, 70),
             _span("render", -1, 200, 300)]
    rec = Recording(spans)
    gaps = [(5, 25), (45, 65), (95, 210)]
    assert rec.innermost_ns(gaps) == {"render": 5 + 5 + 10, "pass": 10 + 10,
                                      "composite": 5 + 5, "warp": 5}
    assert rec.self_ns(1) == 80 - 30 - 10


def test_self_time_of_a_traced_pass(fox_cpu):
    rec = _traced(lambda: _cpu_frame(fox_cpu, spp=1))
    p = next(i for i, s in enumerate(rec.spans) if s.name == "pass")
    kids = sum(rec.spans[k].end_ns - rec.spans[k].start_ns for k in _children(rec, p))
    assert rec.self_ns(p) == rec.spans[p].end_ns - rec.spans[p].start_ns - kids


def test_the_bound_drops_spans_and_counts_them():
    rec = Recorder(capacity=4)
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.frame("render"):
            for _ in range(5):
                with rec.span("pass", device=True):
                    pass
    got = rec.read()
    assert [s.name for s in got.spans] == ["render", "pass", "pass", "pass"]
    assert got.dropped == 2


def test_the_phase_clock_records_its_phases_and_keeps_its_keys():
    rec = tracing.RECORDER
    stats = {"sync_phases": True, "host_wait_s": 0.0}
    with profile(activities=[ProfilerActivity.CPU]):
        clock = PhaseClock(stats, torch.device("cpu"), ("a", "b"))
        time.sleep(0.002)
        clock.phase("a")
        assert clock.any_alive(torch.ones(2, dtype=torch.bool))
        clock.phase("b")
    got = rec.read()
    assert [s.name for s in got.spans] == ["a", "b"]
    assert [s.parent for s in got.spans] == [-1, -1] and {s.frame for s in got.spans} == {0}
    assert got.spans[0].end_ns - got.spans[0].start_ns >= 2_000_000
    assert set(stats["phase_s"]) == {"a", "b"} and stats["phase_s"]["a"] >= 0.002
    assert stats["host_wait_s"] >= 0.0
    off = PhaseClock(None, torch.device("cpu"))
    off.phase("a")
    assert rec.read() is got


class _FakeEvent:
    """A timing event whose time is the order it was recorded in."""

    recorded = 0

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream):
        _FakeEvent.recorded += 1
        self.t = _FakeEvent.recorded

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return float(other.t - self.t)


def test_device_spans_share_one_event_where_they_touch(monkeypatch):
    class Stream:
        device = "card"

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    rec, before = Recorder(), _FakeEvent.recorded
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.frame("render", "cuda"):
            for _ in range(2):
                with rec.span("pass", device=True):
                    for name in ("geometry", "shade", "warp"):
                        with rec.span(name, device=True):
                            pass
            with rec.span("host only"):
                pass
    got = rec.read()
    dev = {(i, s.name): s.device for i, s in enumerate(got.spans)}
    # pass 0 starts at event 1; its first child records its own start (2), the
    # siblings share their ends (3, 4, 5), the pass ends at its last child's end
    assert dev[(1, "pass")] == (0.0, 4.0) and dev[(2, "geometry")] == (1.0, 2.0)
    assert dev[(3, "shade")] == (2.0, 3.0) and dev[(4, "warp")] == (3.0, 4.0)
    # pass 1 starts where pass 0 ended
    assert dev[(5, "pass")] == (4.0, 8.0) and dev[(6, "geometry")] == (5.0, 6.0)
    assert dev[(0, "render")] is None and dev[(9, "host only")] is None
    assert _FakeEvent.recorded - before == 9  # one event a boundary


def test_intervals_overlap_and_idle_gaps():
    events = [("k", 0, 10), ("k", 5, 10), ("k", 30, 5), ("k", 50, 1)]
    assert tracing.idle_intervals(events) == [(15, 30), (35, 50)]
    assert tracing.overlap_ns([(15, 30), (35, 50)], [(0, 20), (40, 100)]) == 5 + 10


# --- on the card -------------------------------------------------------------


@pytest.fixture(scope="module")
def fox_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    s = Session(device="cuda")
    s.load_snapshot(FOX)
    s.bake(resolution=256)
    return s


def _plain_name(name: str) -> str:
    """A kernel's name without its template arguments (K2's counting
    variant differs from the other in one)."""
    while "<" in name:
        new = re.sub(r"<[^<>]*>", "", name)
        if new == name:
            break
        name = new
    return name


@pytest.mark.cuda
def test_the_cuda_only_profiler_turns_the_recorder_on(fox_card):
    from perfbench.trace import DeviceTrace

    assert not tracing.profiling()
    with DeviceTrace():
        assert tracing.profiling()
        fox_card.render(320, 180, _cam(), focal=(275.0, 275.0), spp=2, renderer="sweep")
    rec = tracing.RECORDER.read()
    assert [s.name for s in rec.spans].count("pass") == 2
    dev = [s for s in rec.spans if s.name in ("pass", *PASS_CHILDREN)]
    assert all(s.device is not None and s.device[1] >= s.device[0] for s in dev)
    passes = [rec.spans[i].device for i, s in enumerate(rec.spans) if s.name == "pass"]
    assert passes[0][1] == passes[1][0]  # neighbouring passes share an event
    for p in (i for i, s in enumerate(rec.spans) if s.name == "pass"):
        kids = [rec.spans[k].device for k in _children(rec, p)]
        # the children tile the pass from the first child's start: one event a boundary
        assert kids[0][0] >= rec.spans[p].device[0] and kids[-1][1] == rec.spans[p].device[1]
        assert all(a[1] == b[0] for a, b in zip(kids, kids[1:]))
    assert rec.counters["k2.live_samples"] > 0


@pytest.mark.cuda
def test_spans_share_the_device_traces_clock(fox_card):
    from perfbench.kernels import is_k2
    from perfbench.trace import DeviceTrace
    from sienerf_torch.engines.nerf_sweep import axis_view, sweep_geometry
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel

    eng, (grid, meta) = fox_card.engine, fox_card._baked
    R, K = meta["resolution"], meta["n_cascades"]
    g = sweep_geometry(eng, _cam(), (1100.0, 1100.0), width=1280, height=720, device="cuda")
    vol = shade_volume(grid["rows"], grid["scale"], g["o"][0], fox_card.render_params()["rgb_mlp"],
                       resolution=R, n_cascades=K, density_act=eng.net.density_activation,
                       rgb_act=eng.net.rgb_activation, rgb_mlp=eng.net.rgb_mlp)
    torch.cuda.synchronize()
    rec = tracing.RECORDER
    with DeviceTrace() as trace:
        with rec.frame("render", "cuda"):
            with rec.span("composite", device=True):
                sweep_composite_kernel(axis_view(vol, g["axis"]), g["o_c"], g["eb"], g["ec"],
                                       0.1, 0.01, resolution=R, n_cascades=K,
                                       data_flip=g["flip"])
                torch.cuda.synchronize()
            with rec.span("after"):
                pass
    got = rec.read()
    comp = got.named("composite")[0]
    after = got.named("after")[0]
    (_, k0, kd), = [e for e in trace.events if is_k2(e[0])]
    k1 = k0 + kd
    print(f"clock: K2 starts {(k0 - comp.start_ns) / 1e3:.1f} us after the composite span, "
          f"ends {(comp.end_ns - k1) / 1e3:.1f} us before its end; the next span starts "
          f"{(after.start_ns - k1) / 1e3:.1f} us after K2 ends (tolerance "
          f"{CLOCK_TOLERANCE_NS / 1e3:.0f} us)")
    assert comp.start_ns - CLOCK_TOLERANCE_NS <= k0 and k1 <= comp.end_ns + CLOCK_TOLERANCE_NS
    assert after.start_ns >= k1 - CLOCK_TOLERANCE_NS


@pytest.mark.cuda
def test_the_recorder_leaves_the_device_trace_as_it_was(fox_card, monkeypatch):
    from perfbench.trace import DeviceTrace

    def second_frame():
        frame = lambda: fox_card.render(640, 360, _cam(), focal=(550.0, 550.0), spp=2,  # noqa: E731
                                        renderer="sweep").cpu()
        with DeviceTrace() as trace:
            frame()
            torch.cuda.synchronize()
            split = time.time_ns()
            frame()
            torch.cuda.synchronize()
        tracing.RECORDER.read()
        return Counter(_plain_name(n) for n, s, _ in trace.events if s >= split)

    on = second_frame()
    monkeypatch.setattr(tracing, "profiling", lambda: False)
    off = second_frame()
    print(f"one frame's device events, recorder on and off: {sum(on.values())} / "
          f"{sum(off.values())} of {len(on)} / {len(off)} names")
    assert on == off
    assert not any(n in SPAN_NAMES or "annotation" in n.lower() or "event" in n.lower()
                   for n in on)


@pytest.mark.cuda
def test_k2_counts_the_samples_the_plain_composite_counts(fox_card):
    from perfbench.trace import DeviceTrace
    from sienerf_torch.engines.nerf_sweep import _pick_axis, axis_view, sweep_geometry
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.ops.sweep import sweep_composite
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel

    eng, (grid, meta) = fox_card.engine, fox_card._baked
    R, K = meta["resolution"], meta["n_cascades"]
    params = fox_card.render_params()
    focal, seen = (1100.0, 1100.0), set()
    for k in range(120):  # one camera of each sweep axis
        cam = _cam(k)
        axis = _pick_axis(cam, focal, 1280, 720)[0]
        if axis in seen:
            continue
        seen.add(axis)
        g = sweep_geometry(eng, cam, focal, width=1280, height=720, device="cuda")
        vol = shade_volume(grid["rows"], grid["scale"], g["o"][0], params["rgb_mlp"],
                           resolution=R, n_cascades=K, density_act=eng.net.density_activation,
                           rgb_act=eng.net.rgb_activation, rgb_mlp=eng.net.rgb_mlp)
        view = axis_view(vol, g["axis"])
        args = (g["o_c"], g["eb"], g["ec"], 0.1, eng.render_min_transmittance)
        for phase in (np.float32(0.0625), None):  # pass 0 of spp 8, and no jitter
            kw = dict(phase=phase, resolution=R, n_cascades=K, data_flip=g["flip"])
            quiet = sweep_composite_kernel(view, *args, **kw)
            with DeviceTrace():
                with tracing.RECORDER.frame("render", "cuda"):
                    counting = sweep_composite_kernel(view, *args, **kw)
            counted = tracing.RECORDER.read().counters["k2.live_samples"]
            assert all(torch.equal(a, b) for a, b in zip(quiet, counting))
            stats: dict = {}
            sweep_composite(view.flip(1) if g["flip"] else view, *args, phase=phase,
                            resolution=R, n_cascades=K, stats=stats)
            plain = int(stats["samples"])
            print(f"axis {axis} flip {g['flip']} phase {phase}: K2 counted {counted:,}, "
                  f"plain {plain:,} ({(counted - plain) / plain:+.3e})")
            if phase is not None:
                assert counted == plain
            else:  # the kernel also counts slabs whose sigma is zero everywhere
                assert counted >= plain
    assert seen == {0, 1, 2}
