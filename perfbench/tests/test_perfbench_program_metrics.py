"""The readers of the program's own spans and counters
(sienerf_torch/tracing.py) on a recorder filled by hand and synthetic
device events on the same clock: idle time inside `render`, host us a pass
in K1's and K2's wrappers, the glue's device ms a frame, K2's samples a
second; nothing from an empty recorder, from no events, or from a program
without the recorder."""

from __future__ import annotations

import sys

import pytest

import sienerf_torch
from perfbench import spec
from sienerf_torch import tracing
from sienerf_torch.tracing import Recording, Span

US, MS = 1_000, 1_000_000  # ns
NEW = ["render_idle_ms.video", "launch_host_us.video", "glue_span_ms.video",
       "k2_gsamples_s.video"]


def _frames() -> Recording:
    """Two frames of spp 2: render r ms long from 30 r ms on; each pass 10
    ms, its shade 120 us and composite 30 us on the host; geometry, warp
    and accumulate 1, 2 and 0.5 ms on the device."""
    spans = []
    for f in range(2):
        r0 = 30 * f * MS
        spans.append(Span("render", -1, f, r0, r0 + 25 * MS, None))
        root = len(spans) - 1
        for p in range(2):
            p0 = r0 + 2 * MS + 11 * p * MS
            d0 = float(30 * f + 11 * p)  # device ms after the first event
            spans.append(Span("pass", root, f, p0, p0 + 10 * MS, (d0, d0 + 9.0)))
            parent = len(spans) - 1
            t, d = p0, d0
            for name, host, dev in (("geometry", 500 * US, 1.0), ("shade", 120 * US, 2.0),
                                    ("composite", 30 * US, 4.5), ("warp", 300 * US, 1.0),
                                    ("accumulate", 40 * US, 0.5)):
                spans.append(Span(name, parent, f, t, t + host, (d, d + dev)))
                t, d = t + host + 10 * US, d + dev
    return Recording(spans, {"k2.live_samples": 8 * 10 ** 9})


# device events (name, start ns, duration ns): busy 1-20 ms and 34-50 ms, the
# rest idle; four K2 launches of 2 ms each
EVENTS = [("elementwise", 1 * MS, 5 * MS), ("sweep_kernel<true>", 6 * MS, 2 * MS),
          ("sweep_kernel<true>", 8 * MS, 2 * MS), ("shade_kernel", 10 * MS, 10 * MS),
          ("sweep_kernel<true>", 34 * MS, 2 * MS), ("sweep_kernel<true>", 36 * MS, 2 * MS),
          ("elementwise", 38 * MS, 12 * MS)]


class _Filled:
    """A recorder whose recording was filled by hand."""

    def __init__(self, recording):
        self.recording = recording

    def read(self):
        return self.recording


@pytest.fixture
def recorded(monkeypatch):
    def fill(recording):
        monkeypatch.setattr(tracing, "RECORDER", _Filled(recording))
    return fill


def read(name, events=EVENTS):
    return spec.metric_reader(name)({"events": events})


def test_idle_inside_render_spans(recorded):
    recorded(_frames())
    # the gap 20-34 ms: render 0 ends at 25 (5 ms), render 1 starts at 30 (4 ms);
    # before the first event and after the last nothing is a gap
    assert read("render_idle_ms.video") == pytest.approx((5 + 4) / 2)


def test_host_us_a_pass_in_the_launch_wrappers(recorded):
    recorded(_frames())
    assert read("launch_host_us.video") == pytest.approx(120 + 30)


def test_glue_device_ms_a_frame(recorded):
    recorded(_frames())
    assert read("glue_span_ms.video") == pytest.approx(2 * (1.0 + 1.0 + 0.5))


def test_k2_samples_a_second(recorded):
    recorded(_frames())
    assert read("k2_gsamples_s.video") == pytest.approx(8e9 / 8e-3 / 1e9)


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["empty recorder", "no events", "no recorder"])
def test_a_reader_with_nothing_to_read_returns_nothing(recorded, monkeypatch, name, case):
    recorded(Recording() if case == "empty recorder" else _frames())
    if case == "no recorder":  # the parent of the recorder: the import fails
        monkeypatch.setitem(sys.modules, "sienerf_torch.tracing", None)
        monkeypatch.delattr(sienerf_torch, "tracing")
    assert read(name, None if case == "no events" else EVENTS) is None


def test_host_only_spans_give_no_glue_time(recorded):
    recorded(Recording([s._replace(device=None) for s in _frames().spans]))
    assert read("glue_span_ms.video") is None


def test_the_new_entries_keep_to_the_contract():
    bench = spec.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "frame_ms"
        assert m["workloads"] == ["big.video1080", "base84.video1080"]
        assert m["source"] == ("program_counter" if name.startswith("k2_") else "program_span")
        assert callable(spec.metric_reader(name))
    assert {"sweep glue", "kernel K2"} <= layers
