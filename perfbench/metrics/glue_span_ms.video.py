"""glue_span_ms.video: device ms a frame inside the program's `geometry`,
`warp` and `accumulate` spans (the rays and gnomonic grid, the warp and
epilogue, the float64 spp sum; CUDA events at the span boundaries, waits
included), over the recorded `render` spans (sienerf_torch/tracing.py):
the inside counterpart of rest_device_ms.video."""


def read(ctx):
    try:
        from sienerf_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    rec = tracing.RECORDER.read()
    if not ctx.get("events"):  # no trace, so no recording of it
        return None
    renders = rec.named("render")
    glue = [s.device for name in ("geometry", "warp", "accumulate") for s in rec.named(name)]
    if not renders or not glue or any(d is None for d in glue):
        return None
    return sum(b - a for a, b in glue) / len(renders)
