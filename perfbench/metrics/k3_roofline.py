"""k3_roofline: K3's share of its roofline on the checked frames of the
traced window: each frame's bound (perfbench/bvh_work.py::bound_s, from
the box and triangle tests the benchmark's own walk makes on that frame's
rays and the compulsory bytes) over the device time of that frame's three
K3 launches (primary, shadow, depth-stop; the trace's K3 launches in
order, only when the window launched exactly three a frame)."""

from perfbench.bvh_work import bound_s, is_k3

LAUNCHES_A_FRAME = 3


def read(ctx):
    events, work = ctx.get("events"), ctx.get("bvh_work")
    if not events or not work:
        return None
    c = ctx["counts"]
    k3 = [d for n, _, d in sorted(events, key=lambda e: e[1]) if is_k3(n)]
    if not k3 or len(k3) != c["frames"] * LAUNCHES_A_FRAME or c.get("k3_launches") != len(k3):
        return None
    bound = busy = 0.0
    for pos, w in work.items():
        i = ctx["frame_index"][pos]
        bound += bound_s(w)
        busy += sum(k3[i * LAUNCHES_A_FRAME:(i + 1) * LAUNCHES_A_FRAME]) / 1e9
    return 100.0 * bound / busy if busy > 0 else None
