"""bake_s: seconds of `Session.bake` in set-up, the device synchronised
after it (the benchmark's own span)."""


def read(ctx):
    return ctx["spans"].get("bake")
