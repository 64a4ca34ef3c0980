"""rest_device_ms.video: device ms a frame of every kernel and copy other
than K1 and K2 (the sweep glue, the spp average, the bytes to the host)."""

from perfbench.kernels import is_k1, is_k2


def read(ctx):
    events = ctx.get("events")
    if not events or not ctx["counts"]["frames"]:
        return None
    rest = sum(d for n, _, d in events if not (is_k1(n) or is_k2(n)))
    return rest / 1e6 / ctx["counts"]["frames"]
