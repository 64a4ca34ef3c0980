"""Video traffic: an offline render of a camera path through the program's
main render path, in a closed loop with one renderer.

Set-up loads the configuration's field into a `Session` (a render-only
snapshot through `Session.load_snapshot`, or seeded weights set as the
session's public `engine` and `state` over the snapshot's occupancy grid),
bakes it with `Session.bake`, and renders one frame of each sweep axis and
flip the path has.  The window sends the path's cameras one after the
other: `Session.render(..., spp, renderer="sweep")`, then the frame as
8-bit RGBA on the host, as a video writer takes it; the next frame starts
when those bytes have arrived.  A frame that is not finite fails.

After the window the program's state is freed and the plain reference
(perfbench/reference/) bakes the same field again and renders the sampled
frames (one a sweep axis, drawn from the seed, each as the window last
rendered it); the numbers compared are in perfbench/limits/<cell>.json.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from perfbench import generator, spec
from perfbench.compare import frame_numbers
from perfbench.kernels import is_k2
from perfbench.reference import field as ref_field
from perfbench.reference import sweep as ref_sweep
from perfbench.reference.snapshot import read_render_snapshot
from perfbench.weights import network_dims, seeded_params

NETWORK_KEYS = ("loss", "optimizer", "encoding", "network", "dir_encoding", "rgb_network")
SENTINEL = -32768


def network_of(config: dict) -> dict:
    """The tcnn network config a configuration file runs."""
    return {k: config[k] for k in NETWORK_KEYS}


def frame_format(traffic: dict, overrides: dict) -> dict:
    f = {k: traffic[k] for k in ("width", "height", "focal", "spp", "bake_resolution")}
    f.update({k: v for k, v in overrides.items() if k in f})
    if "width" in overrides and "focal" not in overrides:
        f["focal"] = traffic["focal"] * f["width"] / traffic["width"]
    return f


def to_bytes(rgba: torch.Tensor) -> torch.Tensor:
    """(H, W, 4) f32 -> (H, W, 4) uint8, rounded to nearest."""
    return (rgba.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def load_session(config: dict, seed: int, device):
    """A Session holding the configuration's field, as the program serves it."""
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset
    from sienerf_torch.session import Session

    net = network_of(config)
    w = config["weights"]
    s = Session(device=device)
    if w["kind"] == "snapshot":
        s.load_snapshot(spec.ROOT / w["file"])
        got = {k: s.network_config.get(k) for k in NETWORK_KEYS}
        if got != net:
            raise RuntimeError(f"the program runs {got}, the configuration states {net}")
        return s
    if w["kind"] != "seeded":
        raise ValueError(f"unknown weights kind {w['kind']!r}")
    bitfield = read_render_snapshot(spec.ROOT / w["occupancy"])["bitfield"]
    s.engine = NerfEngine.create(net, NerfDataset.placeholder(config["aabb_scale"]),
                                 device=device)
    s.network_config = net
    s.state = {"params": seeded_params(net, seed, device),
               "occ": {"bitfield": torch.from_numpy(bitfield.copy()).to(device)}, "step": 0}
    return s


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
          t0: float, overrides: dict) -> dict:
    """Set-up and the window -> what the run measured and the sampled
    frames' bytes."""
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel

    fmt = frame_format(traffic, overrides)
    W, H, spp, R = fmt["width"], fmt["height"], fmt["spp"], fmt["bake_resolution"]
    focal = (float(fmt["focal"]),) * 2
    path = dict(traffic["path"], **overrides.get("path", {}))
    cams = generator.camera_path(path, seed)
    sample = generator.check_sample(cams, seed, traffic["check"]["frames_per_axis"])

    t = time.perf_counter()
    if torch.device(device).type == "cuda":
        from sienerf_torch.ops import cuda_lib

        cuda_lib.build()  # a checkout's first run compiles; later runs find the libraries
    spans = {"build": time.perf_counter() - t}
    t = time.perf_counter()
    s = load_session(config, seed, device)
    spans["load"] = time.perf_counter() - t
    t = time.perf_counter()
    grid, meta = s.bake(resolution=R)
    _sync(device)
    spans["bake"] = time.perf_counter() - t
    kept = int((grid["rows"][:, 0] != SENTINEL).sum())
    counts = {"kept_rows": kept, "rows": int(grid["rows"].shape[0]),
              "n_cascades": int(meta["n_cascades"]), "resolution": R,
              "n_scales": int(grid["scale"].numel())}
    del grid

    def frame(cam):
        return s.render(W, H, cam, focal=focal, spp=spp, renderer="sweep")

    t = time.perf_counter()
    seen = set()
    for cam in cams:  # one frame of each sweep axis and flip: every shape the window uses
        if generator.sweep_axis(cam) not in seen:
            seen.add(generator.sweep_axis(cam))
            to_bytes(frame(cam)).cpu()
    _sync(device)
    spans["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    k1_0, k2_0 = shade_volume.launches, sweep_composite_kernel.launches
    times, to_host, failed, kept_bytes, order, last_of_axis = [], [], 0, {}, [], {}
    tracer = None
    if trace and torch.device(device).type == "cuda":  # CUDA activity: the card's only
        from perfbench.trace import DeviceTrace

        tracer = DeviceTrace().__enter__()
    start = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter()
        if now - start >= seconds:
            break
        pos = i % len(cams)
        rgba = frame(cams[pos])
        bad = ~torch.isfinite(rgba).all()
        u8 = to_bytes(rgba)
        t_copy = time.perf_counter()
        host = u8.cpu().numpy()
        failed += int(bad.item())
        done = time.perf_counter()
        times.append(done - now)
        to_host.append(done - t_copy)
        order.append(pos)
        if pos in sample:
            kept_bytes[pos] = (i, host)
        last_of_axis[generator.sweep_axis(cams[pos])[0]] = (pos, i, host)
        i += 1
    window_s = time.perf_counter() - start
    if tracer is not None:
        tracer.__exit__(None, None, None)
    counts.update(frames=i, k1_launches=shade_volume.launches - k1_0,
                  k2_launches=sweep_composite_kernel.launches - k2_0)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    del s, frame
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"times": times, "to_host": to_host, "failed": failed, "window_s": window_s,
            "setup_s": setup_s, "spans": spans, "counts": counts, "order": order,
            "frames": _checked_frames(cams, sample, kept_bytes, last_of_axis),
            "cams": cams, "format": fmt,
            "events": tracer.events if tracer is not None else None,
            "memory_peak_bytes": int(peak)}


def window_metrics(times, window_s: float) -> dict:
    """Frame times (s, dispatch to bytes on the host) and the window's
    length -> frame_ms, the window over every frame finished in it, and
    frame_p95_ms, the 95th percentile of every frame's time."""
    if not times:
        return {"frame_ms": float("nan"), "frame_p95_ms": float("nan")}
    return {"frame_ms": 1e3 * window_s / len(times),
            "frame_p95_ms": float(1e3 * np.percentile(np.asarray(times, np.float64), 95))}


def _checked_frames(cams, sample, kept, last_of_axis) -> dict:
    """The frames the check compares -> {path position: (frame number,
    bytes)}: each sampled position as the window last rendered it; where a
    short window never reached one, the last frame of its sweep axis."""
    out = {}
    for pos in sample:
        if pos in kept:
            out[pos] = kept[pos]
            continue
        alt = last_of_axis.get(generator.sweep_axis(cams[pos])[0])
        if alt is not None and alt[0] not in out:
            out[alt[0]] = alt[1:]
    return out


def reference_frames(config: dict, seed: int, cams: list, positions: list, fmt: dict,
                     device, precision: str = "bf16", stats: dict | None = None) -> dict:
    """The plain reference's frames at the given path positions -> {pos:
    uint8 (H, W, 4)}; `stats` receives each pass's composite counts."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _reference_frames(config, seed, cams, positions, fmt, device, precision, stats)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def _reference_frames(config, seed, cams, positions, fmt, device, precision, stats):
    net = network_of(config)
    w = config["weights"]
    grid = ref_field.grid_spec(net["encoding"], config["aabb_scale"])
    if w["kind"] == "snapshot":
        snap = read_render_snapshot(spec.ROOT / w["file"])
        table = torch.from_numpy(snap["grid_fp8"].copy()).to(device)
        rows_of = ref_field.fp8_rows(table, torch.from_numpy(snap["grid_scale"]).to(device),
                                     grid["F"])
        dens_w = [torch.from_numpy(x).to(device) for x in snap["density_mlp"]]
        rgb_w = [torch.from_numpy(x).to(device) for x in snap["rgb_mlp"]]
        bitfield = snap["bitfield"]
    else:
        p = seeded_params(net, seed, device)
        rows_of = ref_field.f32_rows(p["grid"], grid["F"])
        dens_w, rgb_w = p["density_mlp"], p["rgb_mlp"]
        bitfield = read_render_snapshot(spec.ROOT / w["occupancy"])["bitfield"]
    bitfield = torch.from_numpy(bitfield.copy()).to(device)
    rows, scale = ref_field.bake(lambda u: ref_field.hash_encode(grid, rows_of, u), dens_w,
                                 bitfield, fmt["bake_resolution"], config["aabb_scale"],
                                 precision)
    out = {}
    for pos in positions:
        st = [] if stats is not None else None
        rgba = ref_sweep.render(rows, scale, rgb_w, cams[pos], (float(fmt["focal"]),) * 2,
                                fmt["width"], fmt["height"], fmt["spp"],
                                fmt["bake_resolution"], bitfield.shape[0], precision, st)
        out[pos] = to_bytes(rgba).cpu().numpy()
        if stats is not None:
            stats[pos] = st
    return out


def run(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t0: float, overrides: dict | None = None) -> dict:
    """One run of a video cell -> the pieces of the result line."""
    overrides = overrides or {}
    config = spec.patched(config, overrides.get("config", {}))
    got = serve(config, traffic, seed, seconds, trace, device, t0, overrides)
    fmt, frames = got["format"], got["frames"]
    stats = {} if trace else None
    t = time.perf_counter()
    ref = reference_frames(config, seed, got["cams"], sorted(frames), fmt, device, stats=stats)
    numbers = frame_numbers([(frames[p][1], ref[p]) for p in sorted(frames)])
    print(f"perfbench: set-up {got['setup_s']:.3f} s {got['spans']}; window "
          f"{got['window_s']:.3f} s, {len(got['times'])} frames; reference "
          f"{time.perf_counter() - t:.3f} s for {len(ref)} frames", file=sys.stderr)
    n = len(got["times"])
    end_to_end = dict(window_metrics(got["times"], got["window_s"]), setup_s=got["setup_s"])
    ctx = {"spans": got["spans"], "counts": got["counts"], "events": got["events"],
           "window_s": got["window_s"], "format": fmt,
           "rgb_dims": network_dims(network_of(config))["rgb_mlp"],
           "k2_stats": stats, "frame_index": {p: frames[p][0] for p in frames}}
    return {"attempted": n, "failed": got["failed"], "end_to_end": end_to_end, "ctx": ctx,
            "numbers": numbers, "memory_peak_bytes": got["memory_peak_bytes"],
            "gap_label": _gap_labeler(got["events"], fmt["spp"])}


def _gap_labeler(events, spp: int):
    """Names an idle gap of the trace by what the host was doing: between
    two frames (the bytes of one going to the host, the next one's set-up)
    or inside a frame's spp loop, with the operation that ends the gap."""
    if events is None:
        return None
    k2_before = np.cumsum([0] + [is_k2(n) for n, _, _ in events])

    def label(i: int) -> str:
        n2 = int(k2_before[i])
        where = "between frames" if n2 % spp == 0 else f"frame, after pass {n2 % spp}"
        return f"{where}; then {events[i][0][:60]}"
    return label
