"""The device trace of a window and its reduction, all in memory.

`DeviceTrace` runs torch.profiler with CUDA activity only and keeps the
device events (kernels, copies, sets) as (name, start ns, duration ns),
read from the profiler's raw kineto events (key_averages builds a Python
object a record, which took most of a minute on a long trace).  The
reductions below work on that list, so the CPU tests feed them synthetic
events.
"""

from __future__ import annotations


class DeviceTrace:
    """With `warmup` w, the profiler traces and drops what runs before the
    w-th `step()` (its start-up slows the work it first traces), then
    keeps everything until the block ends."""

    def __init__(self, warmup: int = 0):
        self.events: list[tuple[str, int, int]] = []
        self.warmup = warmup
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, schedule

        kw = {}
        if self.warmup:
            kw["schedule"] = schedule(wait=0, warmup=self.warmup, active=1 << 30, repeat=1)
        self._prof = profile(activities=[ProfilerActivity.CUDA], **kw)
        self._prof.__enter__()
        return self

    def step(self) -> None:
        self._prof.step()

    def __exit__(self, *exc):
        import torch

        self._prof.__exit__(*exc)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                self.events.append((e.name(), int(e.start_ns()), int(e.duration_ns())))
        self.events.sort(key=lambda x: x[1])
        self._prof = None
        return False


def union_ns(events) -> int:
    """The length of the union of the events' intervals."""
    total, end = 0, None
    for _, s, d in sorted(events, key=lambda x: x[1]):
        e = s + d
        if end is None or s >= end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def top_ops(events, n: int = 10) -> list:
    """The device operations that took the most time -> [[name, seconds]]."""
    by: dict[str, int] = {}
    for name, _, d in events:
        by[name] = by.get(name, 0) + d
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], ns / 1e9] for name, ns in top]


def idle_gaps(events, label, n: int = 10) -> list:
    """The longest gaps between device operations -> [[name, seconds]], each
    named by `label(i)`, where i is the index of the first event after it."""
    gaps, end = [], None
    for i, (_, s, d) in enumerate(sorted(events, key=lambda x: x[1])):
        if end is not None and s > end:
            gaps.append((s - end, i))
        end = s + d if end is None else max(end, s + d)
    gaps.sort(key=lambda g: -g[0])
    return [[label(i), ns / 1e9] for ns, i in gaps[:n]]
