"""idle_pct.video: the share of the traced window in which no operation
ran on the device (one minus the union of the device intervals)."""

from perfbench.trace import union_ns


def read(ctx):
    events = ctx.get("events")
    if not events:
        return None
    return 100.0 * (1.0 - union_ns(events) / 1e9 / ctx["window_s"])
