"""mesh_ms.hybrid: device ms a frame inside the hybrid frame's `mesh` and
`depth_trace` phases (the mesh pass with its shadow rays and BRDF, and
the trace of the sweep's per-pixel stop; CUDA events at the phase
boundaries, waits included), over the recorded `render` spans
(sienerf_torch/tracing.py, engines/geometry.py's PhaseClock)."""


def read(ctx):
    try:
        from sienerf_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    if not ctx.get("events"):  # no trace, so no recording of it
        return None
    rec = tracing.RECORDER.read()
    renders = rec.named("render")
    mesh = [s.device for name in ("mesh", "depth_trace") for s in rec.named(name)]
    if not renders or not mesh or any(d is None for d in mesh):
        return None
    return sum(b - a for a, b in mesh) / len(renders)
