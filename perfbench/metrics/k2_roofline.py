"""k2_roofline: K2's share of its roofline on the checked frames of the
traced window: each pass's bound (perfbench/peaks.py::k2_bound_s) from the
samples and texels the reference's plain composite counts on the same
pass, summed over the frame's passes, over the device time of that frame's
K2 launches (the trace's K2 launches in order, spp a frame; only when the
window launched exactly spp a frame)."""

from perfbench.kernels import is_k2
from perfbench.peaks import k2_bound_s


def _aligned(x: float) -> int:
    return -(-int(x) // 128) * 128


def read(ctx):
    events, stats = ctx.get("events"), ctx.get("k2_stats")
    if not events or not stats:
        return None
    fmt, c = ctx["format"], ctx["counts"]
    spp = fmt["spp"]
    k2 = [d for n, _, d in sorted(events, key=lambda e: e[1]) if is_k2(n)]
    if len(k2) != c["frames"] * spp or c["k2_launches"] != len(k2):
        return None
    hi, wi = _aligned(1.15 * fmt["height"]), _aligned(1.15 * fmt["width"])
    bound = busy = 0.0
    for pos, passes in stats.items():
        i = ctx["frame_index"][pos]
        bound += sum(k2_bound_s(p["samples"], p["texels"], c["n_cascades"], c["resolution"],
                                hi, wi) for p in passes)
        busy += sum(k2[i * spp:(i + 1) * spp]) / 1e9
    return 100.0 * bound / busy if busy > 0 else None
