"""render_idle_ms.video: device-idle ms a frame inside the program's
`render` spans: the gaps between the union of the traced device events
that fall inside the host's `Session.render` calls, on the clock the
spans share with the trace (sienerf_torch/tracing.py), over the recorded
frames.  The rest of idle_pct.video's idle time is the caller's loop
between frames."""


def read(ctx):
    events = ctx.get("events")
    try:
        from sienerf_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    renders = [(s.start_ns, s.end_ns) for s in tracing.RECORDER.read().named("render")]
    if not events or not renders:
        return None
    idle = tracing.overlap_ns(tracing.idle_intervals(events), sorted(renders))
    return idle / 1e6 / len(renders)
