"""k2_gsamples_s.video: K2's composited samples a second, in billions: the
program's device counter `k2.live_samples` (the samples every K2 launch of
the recording composited; sienerf_torch/tracing.py, csrc/sweep.cu) over
the summed device time of the K2 launches in the traced window."""

from perfbench.kernels import is_k2


def read(ctx):
    events = ctx.get("events")
    try:
        from sienerf_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    samples = tracing.RECORDER.read().counters.get("k2.live_samples")
    if not events or samples is None:
        return None
    k2_ns = sum(d for n, _, d in events if is_k2(n))
    return samples / k2_ns if k2_ns else None
