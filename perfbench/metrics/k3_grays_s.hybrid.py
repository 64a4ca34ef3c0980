"""k3_grays_s.hybrid: rays K3 walked a second, in billions: the program's
device counter `k3.rays` (the rays every K3 launch of the recording
walked, a shadow launch counting only the rays its hit mask lets through;
sienerf_torch/tracing.py, ops/bvh_kernel.py) over the summed device time
of the K3 launches in the traced window."""

from perfbench.bvh_work import is_k3


def read(ctx):
    events = ctx.get("events")
    try:
        from sienerf_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    rays = tracing.RECORDER.read().counters.get("k3.rays")
    if not events or not rays:
        return None
    k3_ns = sum(d for n, _, d in events if is_k3(n))
    return rays / k3_ns if k3_ns else None
