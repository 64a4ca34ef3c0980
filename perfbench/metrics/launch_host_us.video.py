"""launch_host_us.video: host us a pass inside the program's `shade` and
`composite` spans (K1's and K2's wrappers from call to return: argument
checks, library load, device properties, ctypes set-up, the launch), over
the recorded `pass` spans (sienerf_torch/tracing.py)."""


def read(ctx):
    try:
        from sienerf_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    rec = tracing.RECORDER.read()
    if not ctx.get("events"):  # no trace, so no recording of it
        return None
    passes = rec.named("pass")
    if not passes:
        return None
    host = sum(s.end_ns - s.start_ns for s in rec.named("shade") + rec.named("composite"))
    return host / 1e3 / len(passes)
