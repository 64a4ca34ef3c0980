"""The program's own spans and counters, on the clock of the device trace.

A span is a named stretch of the host's work: its parent, the frame it
belongs to (the sequence number of the root span around it, from 0 in each
recording), and its host start and end in ns.  A device span also records
a CUDA event at each end, on the root's stream, and so has a device
interval: from the stream reaching its first operation to the stream
finishing its last, waits included.  Spans that touch share one event: a
device span opened right after its previous sibling's end starts at that
event, and one closed right after its last child's end ends at that
child's event.  So device work the host enqueues between two siblings
counts to the later one, and a pass's children tile the pass from its
first child's start; a first child records its own start, so what the
parent does before it (on the host, and on the device) is the parent's
self time.
A counter is a name and an integer: an int64 on the card that a kernel
adds to (`device_counter`), read into the recording's counters when the
recording is read, never inside it.

On or off.  The recorder is on exactly while a torch.profiler session
records: a root span (`Recorder.frame`, one a `Session.render` call) asks
the profiler's own check once, and its children follow that decision.
Off, a span is one attribute check that returns the shared `NOOP`, and no
event or counter is touched.  A root that finds the profiler on starts a
new recording (the last one is cleared) unless one is open; one that finds
it off, or a `read()`, ends it.  Spans go into no profiler event stream (no
`record_function`, no NVTX): the device trace's metrics sum every device
event, and user ranges would land among them.

Clock.  Host times are `time.time_ns()`, the Unix clock.  That is the clock
of the kineto events' `start_ns()`: the profiler stamps host and device
activities with its own approximate clock and converts them to Unix time,
so the spans and a trace's device events share one timeline with no offset.
A monotonic clock with an offset taken at the start would drift from it
wherever the system clock is slewed.

Memory.  At most `capacity` spans a recording (2^18); the ones beyond are
dropped and counted (`Recording.dropped`).  CUDA events come from a pool
that each recording reuses, and are read only by `read()`.

Launch counters.  The `.launches` integers on the kernel wrappers
(`ops/shade.py::shade_volume`, `ops/sweep_kernel.py::sweep_composite_kernel`,
`ops/gather.py::gather_rows`, `gather_small`,
`ops/bvh_kernel.py::bvh_walk_kernel`) count every launch, on or off, and
stay where their readers (the benchmark, `chip_smoke.py`, the tests) find
them.

The spans of a sweep frame (`Session.render`,
`engines/nerf_sweep.py::render_frame_sweep`): `render` (host only), and
in it one `pass` a spp pass holding `geometry`, `shade`, `composite`,
`warp` and `accumulate` (all device spans); counter `k2.live_samples`
(the samples K2 composited, a device counter).  `PhaseClock`'s phases are
device spans too: the hybrid frame's (`engines/geometry.py`) are `mesh`,
`depth_trace`, `shade`, `sweep` and `rest`, and each BVH walk inside them
is a `bvh` device span; counter `k3.rays` (the rays K3 walked, a masked
launch counting its mask's rays, a device counter added to by
`ops/bvh_kernel.py`).  PERF.md lists which metric reads each.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

CAPACITY = 1 << 18


def profiling() -> bool:
    """Whether a torch.profiler session records (also under CUDA-only
    activities): the profiler's own check."""
    return torch._C._autograd._profiler_enabled()


class Span(NamedTuple):
    name: str
    parent: int  # index in Recording.spans, -1 for a root
    frame: int  # the root's sequence number in its recording
    start_ns: int  # host, Unix clock
    end_ns: int | None  # None while open
    device: tuple | None  # (start, end) ms after the recording's first event; None: host only


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Open:
    """An open span of a recording."""

    __slots__ = ("rec", "name", "timed", "root", "device", "index")

    def __init__(self, rec, name: str, timed: bool, root: bool = False, device=None):
        self.rec, self.name, self.timed, self.root, self.device = rec, name, timed, root, device
        self.index = -1

    def __enter__(self):
        self.rec._enter(self)
        return self

    def __exit__(self, *exc):
        self.rec._exit(self)
        return False


def overlap_ns(xs, ys) -> int:
    """The length of the intersection of two lists of (start, end)
    intervals, each sorted by start and disjoint within itself."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_intervals(events) -> list:
    """The gaps between the union of a trace's device events (name,
    start ns, duration ns) -> sorted [(start, end)] on the trace's clock."""
    gaps, end = [], None
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = s + d if end is None else max(end, s + d)
    return gaps


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Recording:
    """What a recording holds once read: closed spans resolved to numbers."""

    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    dropped: int = 0

    def __post_init__(self):
        self._children = [[] for _ in self.spans]
        for i, s in enumerate(self.spans):
            if s.parent >= 0:
                self._children[s.parent].append(i)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name and s.end_ns is not None]

    def self_ns(self, i: int) -> int:
        """Span i's host duration minus the part of it its children cover."""
        s = self.spans[i]
        kids = [(max(c.start_ns, s.start_ns), min(c.end_ns, s.end_ns))
                for c in (self.spans[k] for k in self._children[i]) if c.end_ns is not None]
        return s.end_ns - s.start_ns - sum(b - a for a, b in _union(kids) if b > a)

    def innermost_ns(self, intervals) -> dict:
        """How much of `intervals` (sorted, disjoint (start, end) on the
        shared clock) each span name covers as the innermost open span ->
        {name: ns}; what no span covers is left out."""
        pieces: dict = {}
        for i, s in enumerate(self.spans):
            if s.end_ns is None:
                continue
            cut = _union((self.spans[k].start_ns, self.spans[k].end_ns)
                         for k in self._children[i] if self.spans[k].end_ns is not None)
            a = s.start_ns
            for c0, c1 in cut + [[s.end_ns, s.end_ns]]:
                if c0 > a:
                    pieces.setdefault(s.name, []).append((a, min(c0, s.end_ns)))
                a = max(a, c1)
        out = {}
        for name, p in pieces.items():
            covered = overlap_ns(sorted(p), intervals)
            if covered:
                out[name] = covered
        return out


class _Phases:
    """A PhaseClock's spans: each phase runs from the last boundary to now."""

    __slots__ = ("rec", "parent", "frame", "stream", "t", "ev")

    def __init__(self, rec, parent: int, frame: int, stream):
        self.rec, self.parent, self.frame, self.stream = rec, parent, frame, stream
        self.t = time.time_ns()
        self.ev = rec._event(stream) if stream is not None else None

    def close(self, name: str) -> None:
        now = time.time_ns()
        if self.rec._full():
            return
        ev = self.rec._event(self.stream) if self.stream is not None else None
        self.rec._add(name, self.parent, self.frame, self.t, now, self.ev, ev)
        self.t, self.ev = now, ev

    def skip(self) -> None:
        """The host's time until now belongs to no phase."""
        self.t = time.time_ns()


class Recorder:
    """Spans and counters of the frames that run under torch.profiler (see
    the module docstring).  One thread records at a time."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.on = False
        self.dropped = 0
        self._open = False  # a recording takes spans
        self._spans: list = []  # [name, parent, frame, t0, t1, event0, event1]
        self._stack: list = []
        self._frame = -1
        self._stream = None  # the root's CUDA stream; None on the CPU
        self._mark = None  # the event of the last span's end, if it recorded one
        self._pool: list = []  # timing events, reused by each recording
        self._pool_device = None
        self._used = 0
        self._device_counters: dict = {}
        self._counted: set = set()  # the device counters of this recording
        self._result = None

    # --- recording -----------------------------------------------------

    def frame(self, name: str = "render", device=None):
        """A root span: asks whether the profiler records, and its children
        follow.  Inside another root it is an ordinary span."""
        if self.on:
            return _Open(self, name, False)
        if not profiling():
            self._open = False
            return NOOP
        return _Open(self, name, False, root=True,
                     device=torch.device(device) if device is not None else None)

    def span(self, name: str, device: bool = False):
        """A span of the current root (a device span with `device`)."""
        if not self.on:
            return NOOP
        return _Open(self, name, device)

    def device_counter(self, name: str, device) -> torch.Tensor:
        """The int64 on `device` that a kernel adds counter `name` to while
        the recorder is on (zeroed once a recording, the first time)."""
        t = self._device_counters.get(name)
        if t is None or t.device != torch.device(device):
            t = torch.zeros((), dtype=torch.int64, device=device)
            self._device_counters[name] = t
        self._counted.add(name)
        return t

    def phases(self, device):
        """A PhaseClock's recording: inside a root its phases are children
        of the open span; outside one, under the profiler, each clock is a
        frame of its own -> _Phases, or None when nothing records."""
        if not self.on:
            if not profiling():
                self._open = False
                return None
            if not self._open:
                self._begin()
            self._frame += 1
        dev = torch.device(device)
        stream = self._stream if self.on else (
            torch.cuda.current_stream(dev) if dev.type == "cuda" else None)
        return _Phases(self, self._stack[-1] if (self.on and self._stack) else -1,
                       self._frame, stream)

    def _begin(self) -> None:
        if self._result is None:  # the last recording was never read: its counts are stale
            self._device_counters.clear()
        self._open = True
        self._spans, self._stack, self._counted = [], [], set()
        self._frame, self.dropped, self._used, self._result = -1, 0, 0, None

    def _event(self, stream) -> torch.cuda.Event:
        if stream.device != self._pool_device:  # an event stays on the card it first recorded on
            self._pool, self._pool_device = self._pool[:0], stream.device
            self._used = 0
        if self._used == len(self._pool):
            self._pool.append(torch.cuda.Event(enable_timing=True))
        ev = self._pool[self._used]
        self._used += 1
        ev.record(stream)
        return ev

    def _full(self) -> bool:
        """True, and one more span dropped, when the recording is full."""
        if len(self._spans) < self.capacity:
            return False
        self.dropped += 1
        return True

    def _add(self, name, parent, frame, t0, t1, e0, e1) -> int:
        self._spans.append([name, parent, frame, t0, t1, e0, e1])
        self._mark = e1
        return len(self._spans) - 1

    def _enter(self, s: _Open) -> None:
        if s.root:
            if not self._open:
                self._begin()
            self.on = True
            self._frame += 1
            dev = s.device
            self._stream = torch.cuda.current_stream(dev) \
                if dev is not None and dev.type == "cuda" else None
            self._mark = None
        now = time.time_ns()
        if self._full():
            return
        ev = None
        if s.timed and self._stream is not None:
            ev = self._mark if self._mark is not None else self._event(self._stream)
        s.index = self._add(s.name, self._stack[-1] if self._stack else -1, self._frame, now,
                            None, ev, None)
        self._stack.append(s.index)

    def _exit(self, s: _Open) -> None:
        now = time.time_ns()
        if s.index >= 0:
            self._stack.pop()
            ev = None
            if s.timed and self._stream is not None:
                ev = self._mark if self._mark is not None else self._event(self._stream)
            self._spans[s.index][4] = now
            self._spans[s.index][6] = ev
            self._mark = ev
        if s.root:
            self.on, self._stream, self._mark = False, None, None

    # --- reading -------------------------------------------------------

    def read(self) -> Recording:
        """The recording, resolved (the first read synchronises the card and
        reads the device counters); reading ends it."""
        if self._result is None:
            self._result = self._resolve()
        self._open = False
        return self._result

    def _resolve(self) -> Recording:
        at = {}
        if self._used:
            first = self._pool[0]
            first.synchronize()
            self._pool[self._used - 1].synchronize()
            at = {id(e): first.elapsed_time(e) for e in self._pool[:self._used]}
        spans = []
        for name, parent, frame, t0, t1, e0, e1 in self._spans:
            dev = None
            if id(e0) in at and id(e1) in at:  # both ends on this recording's card
                dev = (at[id(e0)], at[id(e1)])
            spans.append(Span(name, parent, frame, t0, t1, dev))
        counters = {}
        for name in self._counted:
            t = self._device_counters[name]
            counters[name] = int(t.item())
            t.zero_()
        return Recording(spans, counters, self.dropped)


RECORDER = Recorder()


class PhaseClock:
    """Statistics for a caller's `stats` dict: with stats["sync_phases"]
    set, the seconds of each of `phases`, measured by synchronising the
    device after it (which slows the work, so a timed run leaves it
    unset); for a frame also the host's wait for the device's per-round
    answer.  While the recorder records, each `phase(name)` also closes a
    span `name` (a device span on a card, through events, with no
    synchronising)."""

    def __init__(self, stats: dict | None, device: torch.device, phases=()):
        self.stats = stats
        self.sync = bool(stats and stats.get("sync_phases")) and device.type == "cuda"
        if stats is not None and stats.get("sync_phases"):
            stats["phase_s"] = dict.fromkeys(phases, 0.0)
        self._spans = RECORDER.phases(device)
        self._t = time.perf_counter()

    def phase(self, name: str) -> None:
        if self._spans is not None:
            self._spans.close(name)
        if self.stats is None or "phase_s" not in self.stats:
            return
        if self.sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.stats["phase_s"][name] += now - self._t
        self._t = now

    def any_alive(self, alive: torch.Tensor) -> bool:
        t = time.perf_counter()
        out = bool(alive.any())
        if self._spans is not None:
            self._spans.skip()
        if self.stats is not None:
            self.stats["host_wait_s"] += time.perf_counter() - t
            self._t = time.perf_counter()
        return out
