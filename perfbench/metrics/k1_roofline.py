"""k1_roofline: K1's share of its roofline over the traced window: the
bound of one shade of the bake (perfbench/peaks.py::k1_bound_s, from the
bake's kept rows, counted as rows whose first field is not the sentinel)
times the K1 launches in the trace, over their summed device time."""

from perfbench.kernels import is_k1
from perfbench.peaks import k1_bound_s


def read(ctx):
    events = ctx.get("events")
    if not events:
        return None
    k1 = [d for n, _, d in events if is_k1(n)]
    if not k1:
        return None
    c = ctx["counts"]
    bound = k1_bound_s(c["rows"], c["kept_rows"], c["n_cascades"], c["resolution"],
                       ctx["rgb_dims"], c["n_scales"])
    return 100.0 * bound * len(k1) / (sum(k1) / 1e9)
