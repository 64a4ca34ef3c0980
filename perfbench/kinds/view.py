"""View traffic: the video kind's camera path, set-up and window at one
pass a frame (spp 1), as a viewer renders: `Session.render(..., spp=1,
renderer="sweep")` then the frame as 8-bit RGBA on the host, in a closed
loop with one renderer (perfbench/kinds/video.py::serve).

Only the check differs: at spp 1 the program renders every pixel's centre
and every slab unjittered, so the plain reference is
perfbench/reference/view.py's one-pass frame, over the same bake as the
video kind's reference; the numbers compared are in
perfbench/limits/<cell>.json.
"""

from __future__ import annotations

import sys
import time

import torch

from perfbench import spec
from perfbench.compare import frame_numbers
from perfbench.kinds import video
from perfbench.reference import field as ref_field
from perfbench.reference import view as ref_view
from perfbench.reference.fields import field_parts
from perfbench.weights import network_dims


@torch.no_grad()
def reference_frames(config: dict, seed: int, cams: list, positions: list, fmt: dict,
                     device, precision: str = "bf16", stats: dict | None = None) -> dict:
    """The plain reference's one-pass frames at the given path positions ->
    {pos: uint8 (H, W, 4)}, TF32 off; `stats` receives each frame's
    composite counts."""
    if fmt["spp"] != 1:
        raise ValueError("the view kind renders one pass a frame (spp 1)")
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        parts = field_parts(config, seed, device)
        bitfield = parts["bitfield"]
        rows, scale = ref_field.bake(parts["encode"], parts["density_w"], bitfield,
                                     fmt["bake_resolution"], config["aabb_scale"], precision)
        out = {}
        for pos in positions:
            st = [] if stats is not None else None
            rgba = ref_view.render(rows, scale, parts["rgb_w"], cams[pos],
                                   (float(fmt["focal"]),) * 2, fmt["width"], fmt["height"],
                                   fmt["bake_resolution"], bitfield.shape[0], precision, st)
            out[pos] = video.to_bytes(rgba).cpu().numpy()
            if stats is not None:
                stats[pos] = st
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t0: float, overrides: dict | None = None) -> dict:
    """One run of a view cell -> the pieces of the result line."""
    overrides = overrides or {}
    config = spec.patched(config, overrides.get("config", {}))
    got = video.serve(config, traffic, seed, seconds, trace, device, t0, overrides)
    fmt, frames = got["format"], got["frames"]
    stats = {} if trace else None
    t = time.perf_counter()
    ref = reference_frames(config, seed, got["cams"], sorted(frames), fmt, device, stats=stats)
    numbers = frame_numbers([(frames[p][1], ref[p]) for p in sorted(frames)])
    print(f"perfbench: set-up {got['setup_s']:.3f} s {got['spans']}; window "
          f"{got['window_s']:.3f} s, {len(got['times'])} frames; reference "
          f"{time.perf_counter() - t:.3f} s for {len(ref)} frames", file=sys.stderr)
    end_to_end = dict(video.window_metrics(got["times"], got["window_s"]),
                      setup_s=got["setup_s"])
    ctx = {"spans": got["spans"], "counts": got["counts"], "events": got["events"],
           "window_s": got["window_s"], "format": fmt,
           "rgb_dims": network_dims(video.network_of(config))["rgb_mlp"],
           "k2_stats": stats, "frame_index": {p: frames[p][0] for p in frames}}
    return {"attempted": len(got["times"]), "failed": got["failed"], "end_to_end": end_to_end,
            "ctx": ctx, "numbers": numbers, "memory_peak_bytes": got["memory_peak_bytes"],
            "gap_label": video._gap_labeler(got["events"], fmt["spp"])}
