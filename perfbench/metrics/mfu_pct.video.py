"""mfu_pct.video: the frames' share of the card's bf16 peak: the colour
MLP's flops at the configuration's widths on the bake's kept vertices,
once a pass (spp a frame), over the traced window at 989 TFLOP/s (K1's
tensor-core precision)."""

from perfbench.peaks import BF16_FLOPS, mlp_flops


def read(ctx):
    c = ctx["counts"]
    if ctx.get("events") is None or not c["frames"]:
        return None
    flops = c["kept_rows"] * mlp_flops(ctx["rgb_dims"]) * ctx["format"]["spp"] * c["frames"]
    return 100.0 * flops / (ctx["window_s"] * BF16_FLOPS)
