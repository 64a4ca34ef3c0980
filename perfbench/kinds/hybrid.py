"""Hybrid traffic: an offline render of a camera path through the fork's
hybrid scene (meshes inside a NeRF) on the program's main render path, in
a closed loop with one renderer.

Set-up writes the configuration's meshes from the seed as .obj files and
its scene graph (perfbench/scene.py), loads the scene with
`Session.load_file` (the BVH build), loads the configuration's field into
a second `Session` (perfbench/kinds/video.py::load_session) and binds it
to the scene's NeRF slot with `GeometryEngine.attach_nerf`, bakes it with
`Session.bake` and sets that bake on the object, bakes the probe grid
(`irradiance.bake_probe_grid`) as the meshes' ambient light, and renders
one frame of each sweep axis and flip the path has; it counts the bake's
kept rows for K1's roofline, as the video kind does.  The window sends the
path's cameras one after the other: `Session.render(..., renderer=...)`
on the scene, then the frame as 8-bit RGBA on the host; the next frame
starts when those bytes have arrived.  A frame that is not finite fails.

With `--trace 1` the window runs under the device trace, and after it the
BVH the program built is walked again on every 64th ray of each checked
frame's primary, shadow and depth-stop rays (perfbench/bvh_work.py), for
K3's roofline.  Then the program's state is freed and the plain reference
(perfbench/reference/hybrid.py) renders the sampled frames from the same
.obj files; the numbers compared are in perfbench/limits/<cell>.json.
"""

from __future__ import annotations

import gc
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from perfbench import bvh_work, generator, scene, spec
from perfbench.compare import frame_numbers
from perfbench.kinds.video import (SENTINEL, _checked_frames, _sync, load_session, network_of,
                                   to_bytes, window_metrics)
from perfbench.reference import hybrid as ref_hybrid
from perfbench.weights import network_dims


def frame_format(traffic: dict, overrides: dict) -> dict:
    f = {k: traffic[k] for k in ("width", "height", "focal", "bake_resolution", "renderer")}
    f.update({k: v for k, v in overrides.items() if k in f})
    if "width" in overrides and "focal" not in overrides:
        f["focal"] = traffic["focal"] * f["width"] / traffic["width"]
    return f


def bake_counts(grid: dict, meta: dict, resolution: int) -> dict:
    """What K1's bound reads of the bake, as the video kind counts it."""
    return {"kept_rows": int((grid["rows"][:, 0] != SENTINEL).sum()),
            "rows": int(grid["rows"].shape[0]), "n_cascades": int(meta["n_cascades"]),
            "resolution": resolution, "n_scales": int(grid["scale"].numel())}


def load_scene(config: dict, seed: int, directory: Path, device, fmt: dict, spans: dict):
    """The program's hybrid scene, as a deployment holds it -> (scene
    Session, field Session)."""
    from sienerf_torch.engines import irradiance
    from sienerf_torch.session import Session

    t = time.perf_counter()
    path = scene.write_scene(config, seed, directory)
    spans["meshes"] = time.perf_counter() - t
    t = time.perf_counter()
    s = Session(device=device).load_file(path)
    geo = s.engine
    geo.sun_dir = tuple(float(x) for x in config["scene"]["sun_dir"])
    spans["scene"] = time.perf_counter() - t
    t = time.perf_counter()
    fox = load_session(config, seed, device)
    slot = [i for i, o in enumerate(geo.objects) if o.kind == "nerf"][0]
    geo.attach_nerf(slot, fox.engine, fox.state)
    spans["load"] = time.perf_counter() - t
    t = time.perf_counter()
    geo.objects[slot]._bake = fox.bake(resolution=fmt["bake_resolution"])
    _sync(device)
    spans["bake"] = time.perf_counter() - t
    t = time.perf_counter()
    pg = config["scene"]["probe_grid"]
    box = config["scene"]["probe_box"]
    geo.probe_grid = irradiance.bake_probe_grid(fox.engine, fox.state, box[0], box[1],
                                                grid_size=pg["grid_size"],
                                                env_width=pg["env_width"],
                                                env_height=pg["env_height"])
    geo.shade_mode = "grid"
    _sync(device)
    spans["probes"] = time.perf_counter() - t
    return s, fox


def serve(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
          t0: float, overrides: dict, directory: Path) -> dict:
    """Set-up and the window -> what the run measured and the sampled
    frames' bytes."""
    from sienerf_torch.ops.bvh_kernel import bvh_walk_kernel
    from sienerf_torch.ops.shade import shade_volume

    fmt = frame_format(traffic, overrides)
    W, H = fmt["width"], fmt["height"]
    focal = (float(fmt["focal"]),) * 2
    cams = generator.camera_path(dict(traffic["path"], **overrides.get("path", {})), seed)
    sample = generator.check_sample(cams, seed, traffic["check"]["frames_per_axis"])

    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        from sienerf_torch.ops import cuda_lib

        cuda_lib.build()  # a checkout's first run compiles; later runs find the libraries
    spans = {"build": time.perf_counter() - t}
    s, fox = load_scene(config, seed, directory, device, fmt, spans)
    geo = s.engine
    grid, meta = geo.objects[[o.kind for o in geo.objects].index("nerf")]._bake
    counts = bake_counts(grid, meta, fmt["bake_resolution"])
    del grid, meta

    def frame(cam):
        return s.render(W, H, cam, focal=focal, renderer=fmt["renderer"])

    t = time.perf_counter()
    seen = set()
    for cam in cams:  # one frame of each sweep axis and flip: every shape the window uses
        if generator.sweep_axis(cam) not in seen:
            seen.add(generator.sweep_axis(cam))
            to_bytes(frame(cam)).cpu()
    _sync(device)
    spans["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    k1_0, k3_0 = shade_volume.launches, bvh_walk_kernel.launches
    times, failed, kept_bytes, last_of_axis = [], 0, {}, {}
    tracer = None
    if trace and torch.device(device).type == "cuda":  # CUDA activity: the card's only
        from perfbench.trace import DeviceTrace

        tracer = DeviceTrace().__enter__()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        now = time.perf_counter()
        pos = i % len(cams)
        rgba = frame(cams[pos])
        bad = ~torch.isfinite(rgba).all()
        host = to_bytes(rgba).cpu().numpy()
        failed += int(bad.item())
        times.append(time.perf_counter() - now)
        if pos in sample:
            kept_bytes[pos] = (i, host)
        last_of_axis[generator.sweep_axis(cams[pos])[0]] = (pos, i, host)
        i += 1
    window_s = time.perf_counter() - start
    if tracer is not None:
        tracer.__exit__(None, None, None)
    counts.update(frames=i, k1_launches=shade_volume.launches - k1_0,
                  k3_launches=bvh_walk_kernel.launches - k3_0)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    frames = _checked_frames(cams, sample, kept_bytes, last_of_axis)
    work = None
    if trace:
        work = {p: bvh_work.frame_work(geo, cams[p], focal, W, H) for p in sorted(frames)}
    del s, fox, geo, frame
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"times": times, "failed": failed, "window_s": window_s, "setup_s": setup_s,
            "spans": spans, "counts": counts, "frames": frames, "cams": cams, "format": fmt,
            "events": tracer.events if tracer is not None else None,
            "memory_peak_bytes": int(peak), "bvh_work": work}


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t0: float, overrides: dict | None = None) -> dict:
    """One run of a hybrid cell -> the pieces of the result line."""
    overrides = overrides or {}
    config = spec.patched(config, overrides.get("config", {}))
    directory = Path(tempfile.mkdtemp(prefix="perfbench_hybrid_"))
    try:
        got = serve(config, traffic, seed, seconds, trace, device, t0, overrides, directory)
        fmt, frames = got["format"], got["frames"]
        t = time.perf_counter()
        ref = ref_hybrid.render(config, seed, directory, got["cams"], sorted(frames), fmt,
                                device)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    numbers = frame_numbers([(frames[p][1], ref[p]) for p in sorted(frames)])
    print(f"perfbench: set-up {got['setup_s']:.3f} s {got['spans']}; window "
          f"{got['window_s']:.3f} s, {len(got['times'])} frames; reference "
          f"{time.perf_counter() - t:.3f} s for {len(ref)} frames", file=sys.stderr)
    end_to_end = dict(window_metrics(got["times"], got["window_s"]), setup_s=got["setup_s"])
    ctx = {"spans": got["spans"], "counts": got["counts"], "events": got["events"],
           "window_s": got["window_s"], "format": fmt, "bvh_work": got["bvh_work"],
           "rgb_dims": network_dims(network_of(config))["rgb_mlp"],
           "frame_index": {p: frames[p][0] for p in frames}}
    return {"attempted": len(got["times"]), "failed": got["failed"], "end_to_end": end_to_end,
            "ctx": ctx, "numbers": numbers, "memory_peak_bytes": got["memory_peak_bytes"],
            "gap_label": _gap_labeler(got["events"])}


def _gap_labeler(events):
    """Names an idle gap of the trace by the operation that ends it and how
    many K3 launches came before it (three a frame)."""
    if events is None:
        return None
    k3_before = np.cumsum([0] + [bvh_work.is_k3(n) for n, _, _ in events])

    def label(i: int) -> str:
        return f"after K3 launch {int(k3_before[i])}; then {events[i][0][:60]}"
    return label
