#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's paths end to end at the full width of the committed fox
field (data/fox_render.snap: 8 levels x 4 features, 2^19 rows, fp8 table):

- the serving path: bake R=256 (3 cascades of int16 rows) -> 1280x720
  slab-sweep frames through Session.render, with the hand-written CUDA
  kernels K1 (shade, sienerf_torch/csrc/shade.cu: the colour MLP on the
  tensor cores, a channel-last volume) and K2 (sweep composite,
  sienerf_torch/csrc/sweep.cu: slab intervals, 8-byte texels), K2 on the
  three sweep axes and on a channel-planar copy of the volume;
- the gather probe (sienerf_torch/tools/bench_gather.py) with G1 and G2
  (sienerf_torch/csrc/gather.cu) at the probe's own sizes, each kernel timed
  by bursts of launches and by single calls;
- the live path: Session.render(renderer="live"), the streaming
  ray-marched renderer, at 1280x720, a 160x90 frame of it against the same
  code on the CPU, and the sweep frames' PSNR and SSIM against the live
  frames.

It builds every kernel from the sources in the checkout, holds each against
its plain PyTorch version on the card, checks the sweep frames against the
plain-version frames, counts the kernel launches of each path, and times
frames and kernels.

    python3 chip_smoke.py

Exits non-zero, with no result printed, on any failed check, without a
CUDA device, or outside a checkout of the repo.  The last line of stdout is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SNAP = ROOT / "data" / "fox_render.snap"

WIDTH, HEIGHT = 1280, 720
FOCAL = (1100.0, 1100.0)
BAKE_RES = 256
# three views of the cube centre: sweep axes 0 (flipped), 1 and 2
EYES = ([2.1, 0.5, 0.6], [0.4, -1.3, 0.5], [0.5, 0.5, -1.6])
K1_TOL = dict(rtol=2e-2, atol=2e-3)   # the reference's shade-kernel test
K2_TOL = dict(rtol=1e-4, atol=2e-4)   # the reference's sweep-kernel test
FRAME_TOL = dict(rtol=2e-2, atol=5e-3)
LIVE_SMALL = (160, 90)  # the live frame that is held to the CPU run
# pixels of that frame that may leave FRAME_TOL: exp2 / log2 / exp differ in
# the last bit between the card and the CPU, which can move one sample of a
# ray across a voxel boundary
LIVE_MIN_AGREE = 0.99
LIVE_BIG_TILE = 1 << 17
QUALITY_MIN_DB = 15.0  # a mismatched network config renders fog at ~11 dB
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor and
# f32 CUDA-core FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# the TPU kernels each CUDA kernel replaces, as file:line of their
# pl.pallas_call; the JAX package's name is split so that a search of the
# port for references to it finds only real ones
TPU_OPS = "sienerf_" "tpu/ops"
REPLACES = {"shade": f"{TPU_OPS}/shade_pallas.py:265", "sweep": f"{TPU_OPS}/sweep_pallas.py:298",
            "gather_rows": "tools/bench_pallas_gather.py:83",
            "gather_small": "tools/bench_gather.py:83"}
K1_FLOPS_PER_VERTEX = 2 * (32 * 64 + 64 * 64 + 64 * 3)  # the colour MLP
K2_FLOPS_PER_SAMPLE = 30  # affine map, texel select, alpha (one exp), carry


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, want, rtol, atol) -> float:
    """Hold `got` to `want` elementwise (|g - w| <= atol + rtol |w|), in
    slices along dim 0 to bound memory -> max |g - w|."""
    import torch

    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    max_err, bad, total = 0.0, 0, 0
    for a, b in zip(got.split(1), want.split(1)):
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite values")
        err = (a - b).abs()
        bad += int((err > atol + rtol * b.abs()).sum())
        total += err.numel()
        max_err = max(max_err, float(err.max()))
    check(bad == 0, f"{name}: {bad} of {total} values outside rtol {rtol} atol {atol} "
                    f"(max abs err {max_err:.3g})")
    log(f"  {name}: ok, max abs err {max_err:.3g} over {total} values")
    return max_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "sienerf_torch").is_dir() or not SNAP.exists():
        print("chip_smoke: run from a checkout of the repo", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from sienerf_torch import metrics
    from sienerf_torch.engines.nerf_sweep import axis_view, sweep_geometry
    from sienerf_torch.ops import cuda_lib
    from sienerf_torch.ops.gather import (
        gather_rows,
        gather_rows_plain,
        gather_small,
        gather_small_plain,
    )
    from sienerf_torch.ops.shade import kernel_occupancy, shade_volume, shade_volume_plain
    from sienerf_torch.ops.sweep import sweep_composite
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel, sweep_composite_plain
    from sienerf_torch.session import Session
    from sienerf_torch.tools import bench_gather
    from sienerf_torch.utils.camera import look_at_matrix

    cuda_ms = bench_gather.cuda_ms
    t_all = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # -- 2. build every kernel from the checkout's sources, in parallel
    t = time.time()
    reports = cuda_lib.build(cuda_lib.KERNEL_SOURCES, force=True)
    log(f"[build] {', '.join(cuda_lib.KERNEL_SOURCES)} in {time.time() - t:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    k1_blocks, k1_threads = kernel_occupancy()
    log(f"  shade: {k1_blocks} blocks of {k1_threads} threads "
        f"({k1_blocks * k1_threads // 32} warps) fit an SM")

    # -- 2b. G1 and G2 against their plain versions at the probe's shapes
    # (bit-equal: a gather copies bits), then the probe's entry point with
    # the counts from 0
    gen = torch.Generator(device=dev).manual_seed(1)
    for t32, n, g in bench_gather.G1_CASES:
        table = bench_gather.make_rows_table(t32, dev)
        idx = torch.randint(0, t32 // g, (n,), generator=gen, device=dev, dtype=torch.int32)
        got = gather_rows(table, idx, g)
        torch.cuda.synchronize()
        check(torch.equal(got, gather_rows_plain(table, idx, g)),
              f"G1 T32={t32} g={g} N={n}: kernel differs from its plain version")
        del table, got
    for t, c, dtype, n in bench_gather.G2_CASES:
        table = torch.randn((t, c), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, t, (n,), generator=gen, device=dev, dtype=torch.int32)
        got = gather_small(table, idx)
        torch.cuda.synchronize()
        check(torch.equal(got, gather_small_plain(table, idx)),
              f"G2 T={t} {dtype} N={n}: kernel differs from its plain version")
    log(f"[gather] G1 x{len(bench_gather.G1_CASES)} and G2 x{len(bench_gather.G2_CASES)} "
        f"shapes bit-equal to their plain versions (tolerance 0)")
    gather_rows.launches = gather_small.launches = 0
    probe = bench_gather.run({"g1", "g2"}, dev, reps=20, out=lambda l: log(f"[gather] {l}"))
    torch.cuda.synchronize()
    launches_probe = {"gather_rows": gather_rows.launches,
                      "gather_small": gather_small.launches}
    log(f"[gather] probe entry point: launches {launches_probe}")
    for name, n in launches_probe.items():
        check(n >= 1, f"kernel {name} was never launched by the gather probe")
    check(all(r["equal"] for r in probe), "gather probe: a result differs from plain")
    # the kernel table carries each kernel at its first (largest-table) shape;
    # `ms` is the burst time, `call_ms` one isolated call (bench_gather)
    g1_main = next(r for r in probe if r["name"] == "G1")
    g2_main = next(r for r in probe if r["name"] == "G2" and "T=65536" in r["shape"]
                   and "float32" in r["shape"])
    torch.cuda.empty_cache()

    # -- 3. load the snapshot
    t = time.time()
    sess = Session(device=dev)
    sess.load_snapshot(SNAP)
    eng, params = sess.engine, sess.state["params"]
    log(f"[load] {SNAP.name} in {time.time() - t:.2f} s: grid {eng.net.grid.n_levels}x"
        f"{eng.net.grid.n_features_per_level}, 2^{eng.net.grid.log2_hashmap_size} rows, "
        f"aabb {float(eng.aabb.diag[0])}, step {sess.training_step}")

    # -- 4. bake at R=256
    torch.cuda.synchronize()
    t = time.time()
    grid, meta = sess.bake(resolution=BAKE_RES)
    torch.cuda.synchronize()
    bake_s = time.time() - t
    rows, scale = grid["rows"], grid["scale"]
    R, K = meta["resolution"], meta["n_cascades"]
    Rv = R + 1
    n_live = int((rows[:, 0] != -32768).sum())
    log(f"[bake] R={R} K={K}: rows {tuple(rows.shape)} {rows.dtype}, {n_live} of "
        f"{rows.shape[0]} vertices kept, {bake_s:.2f} s")
    check(0 < n_live < rows.shape[0], "bake kept no vertex or every vertex")
    # how the culled vertices lie: K1 shades kept vertices in batches of 32
    kept = rows[:, 0] != -32768
    per_tile = torch.nn.functional.pad(kept, (0, -kept.numel() % 32)).view(-1, 32).sum(1)
    log(f"[bake] tiles of 32 consecutive vertices: {per_tile.numel()}, "
        f"{int((per_tile > 0).sum())} with a kept vertex, {int((per_tile == 32).sum())} full; "
        f"{-(-n_live // 32)} batches of 32 kept vertices")
    del kept, per_tile

    cams = [look_at_matrix(e, [0.5, 0.5, 0.5]) for e in EYES]
    geo = [sweep_geometry(eng, c, FOCAL, width=WIDTH, height=HEIGHT, device=dev) for c in cams]
    axes = [(g["axis"], g["flip"]) for g in geo]
    log(f"[views] (axis, flip) = {axes}")
    check(sorted(a for a, _ in axes) == [0, 1, 2] and any(f for _, f in axes),
          "the views must sweep all three axes, one flipped")
    g0 = geo[0]
    acts = dict(density_act=eng.net.density_activation, rgb_act=eng.net.rgb_activation)

    # -- 5. K1 against its plain version, the whole fox bake, camera 0
    def shade(g):
        return shade_volume(rows, scale, g["o"][0], params["rgb_mlp"], resolution=R,
                            n_cascades=K, **acts)

    t = time.time()
    vol = shade(g0)
    torch.cuda.synchronize()
    vol_plain = shade_volume_plain(rows, scale, g0["o"][0], params["rgb_mlp"],
                                   resolution=R, n_cascades=K, **acts)
    log(f"[K1] shade vs plain, volume {tuple(vol.shape)} strides {vol.stride()} "
        f"({time.time() - t:.1f} s)")
    check(vol.stride(2) == 1 and vol_plain.stride(2) == 1,
          "K1: the volume is not channel-last")
    k1_err = compare("K1 volume", vol, vol_plain, **K1_TOL)
    check(float(vol[:, :, 3].float().max()) > 0, "K1: empty volume")
    del vol_plain

    # -- 6. K2 against its plain version on the shaded fox volume: the five
    # modes on each of the three views (each on the volume shaded for its own
    # camera) and the generic path on a channel-planar copy
    near = max(0.05, eng.near_distance)
    min_t = eng.render_min_transmittance
    hi, wi = g0["eb"].shape[0], g0["ec"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    t_stop = 0.5 + 2.5 * torch.rand((hi, wi), generator=gen, device=dev)
    k2_err = 0.0
    k2_axis_ms, k2_planar_ms, k2_spread = {}, {}, {}

    def hold(tag, got, want):
        worst = 0.0
        for name, a, b in zip(("C", "opacity", "T", "depth_t"), got, want):
            worst = max(worst, compare(f"K2 {tag} {name}", a, b.contiguous(), **K2_TOL))
        check(float(got[1].max()) > 0.1, f"K2 {tag}: nothing composited")
        return worst

    for g in geo:
        axis = g["axis"]
        v_vol = vol if g is g0 else shade(g)
        view = axis_view(v_vol, axis)
        check(view.stride(2) == 1, "K2: the view is not of channel-last storage")
        args = (view, g["o_c"], g["eb"], g["ec"], near, min_t)
        modes = {
            "nearest": dict(),
            "linear": dict(interp="bilinear"),
            "phase": dict(phase=0.25),
            "t_stop": dict(t_stop=t_stop),
            "data_flip": dict(data_flip=not g["flip"]),
        }
        for mode, kw in modes.items():
            kw = dict(kw)
            kw.setdefault("data_flip", g["flip"])
            t = time.time()
            got = sweep_composite_kernel(*args, resolution=R, n_cascades=K, **kw)
            torch.cuda.synchronize()
            want = sweep_composite_plain(*args, resolution=R, n_cascades=K, **kw)
            log(f"[K2] axis {axis} {mode} at Hi={hi} Wi={wi} ({time.time() - t:.1f} s)")
            k2_err = max(k2_err, hold(f"axis {axis} {mode}", got, want))
            if mode == "nearest":
                want_nearest = want
        kw = dict(resolution=R, n_cascades=K, data_flip=g["flip"])
        times = [cuda_ms(lambda: sweep_composite_kernel(*args, **kw), 1, warmup=1)
                 for _ in range(10)]
        k2_axis_ms[axis] = statistics.median(times)
        k2_spread[axis] = (min(times), max(times))
        # the generic path: the same values in a channel-planar volume
        planar = view.contiguous()
        check(planar.stride(2) != 1, "the channel-planar copy is channel-last")
        got = sweep_composite_kernel(planar, *args[1:], **kw)
        torch.cuda.synchronize()
        k2_err = max(k2_err, hold(f"axis {axis} channel-planar", got, want_nearest))
        k2_planar_ms[axis] = cuda_ms(lambda: sweep_composite_kernel(planar, *args[1:], **kw), 10)
        del planar
        log(f"[K2] axis {axis}: {k2_axis_ms[axis]:.4f} ms (ten timings "
            f"{k2_spread[axis][0]:.4f}-{k2_spread[axis][1]:.4f}); channel-planar copy "
            f"{k2_planar_ms[axis]:.4f} ms")
        del v_vol, view, args, got, want, want_nearest
    view = axis_view(vol, g0["axis"])

    # -- 7. the main path: Session.render on the kernels, counts from 0
    shade_volume.launches = 0
    sweep_composite_kernel.launches = 0
    frames = {}
    for i, cam in enumerate(cams):
        for spp in (1, 2):
            frames[i, spp] = sess.render(WIDTH, HEIGHT, cam, FOCAL, spp=spp, renderer="sweep")
    torch.cuda.synchronize()
    launches = {"shade": shade_volume.launches, "sweep": sweep_composite_kernel.launches}
    n_passes = len(cams) * (1 + 2)
    log(f"[frames] {len(frames)} frames, {n_passes} passes: launches {launches}")
    for name, n in launches.items():
        check(n >= 1, f"kernel {name} was never launched on the frame path")
        check(n == n_passes, f"kernel {name}: {n} launches for {n_passes} passes")
    for (i, spp), img in frames.items():
        ref = sess.render(WIDTH, HEIGHT, cams[i], FOCAL, spp=spp, renderer="sweep",
                          impl="plain")
        check(img.shape == (HEIGHT, WIDTH, 4), f"frame shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), "non-finite frame")
        check(float(img[..., 3].mean()) > 0.05 and float(img[..., :3].std()) > 1e-3,
              "empty or constant frame")
        compare(f"frame view {i} (axis {axes[i][0]}) spp {spp} vs plain", img, ref, **FRAME_TOL)
        log(f"    PSNR vs plain {metrics.psnr(img[..., :3], ref[..., :3]):.2f} dB, mean alpha "
            f"{float(img[..., 3].mean()):.3f}")

    # -- 7b. the live path: the streaming ray-marched renderer at 720p.  It
    # launches none of the hand-written kernels (its gathers are plain
    # indexing, as in the JAX package), so it has no count to read.

    def live_frame(cam, **kw):
        img = sess.render(WIDTH, HEIGHT, cam, FOCAL, spp=1, renderer="live", **kw)
        torch.cuda.synchronize()
        return img

    t = time.perf_counter()
    live0 = live_frame(cams[0])  # warm-up
    log(f"[live] warm-up frame {time.perf_counter() - t:.2f} s")
    live_ms, live_stats = [], {}
    for _ in range(3):
        live_stats = {}
        t = time.perf_counter()
        live_frame(cams[0], stats=live_stats)
        live_ms.append(1e3 * (time.perf_counter() - t))
    live_med = statistics.median(live_ms)
    check(live0.shape == (HEIGHT, WIDTH, 4), f"live frame shape {tuple(live0.shape)}")
    check(bool(torch.isfinite(live0).all()), "non-finite live frame")
    check(float(live0[..., 3].mean()) > 0.05 and float(live0[..., :3].std()) > 1e-3,
          "empty or constant live frame")
    log(f"[live] 1280x720 spp1 tile 2^14: median {live_med:.1f} ms (runs "
        f"{[round(x, 1) for x in live_ms]}), {live_stats['rounds']} rounds, host waited "
        f"{1e3 * live_stats['host_wait_s']:.1f} ms for the device "
        f"({100 * 1e3 * live_stats['host_wait_s'] / live_ms[-1]:.1f} % of the frame)")
    phases = {"sync_phases": True}
    t = time.perf_counter()
    live_frame(cams[0], stats=phases)
    synced_ms = 1e3 * (time.perf_counter() - t)
    log(f"[live] where the time goes (one frame with a device sync after every phase, "
        f"{synced_ms:.1f} ms): "
        + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in phases["phase_s"].items()))
    big_ms, big_stats = [], {}
    big = live_frame(cams[0], tile=LIVE_BIG_TILE)
    for _ in range(3):
        big_stats = {}
        t = time.perf_counter()
        live_frame(cams[0], tile=LIVE_BIG_TILE, stats=big_stats)
        big_ms.append(1e3 * (time.perf_counter() - t))
    log(f"[live] tile 2^17: median {statistics.median(big_ms):.1f} ms, "
        f"{big_stats['rounds']} rounds, host waited {1e3 * big_stats['host_wait_s']:.1f} ms")
    compare("live frame tile 2^17 vs tile 2^14", big, live0, rtol=0.0, atol=1e-6)
    # the device's busy share of a tile-2^17 frame: the kernels' summed time in
    # a profiler trace over the untraced frame's median time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        live_frame(cams[0], tile=LIVE_BIG_TILE)
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    if busy_ms > 0:
        log(f"[live] tile 2^17 trace: {n_kernels} device kernels, busy {busy_ms:.1f} ms = "
            f"{100 * busy_ms / statistics.median(big_ms):.1f} % of the frame "
            f"({n_kernels / big_stats['rounds']:.0f} kernels a round)")
    else:
        log("[live] device busy share: not measured (the trace holds no device time)")

    # the same port code on the CPU, at 160x90
    sw, sh = LIVE_SMALL
    focal_s = tuple(f * sw / WIDTH for f in FOCAL)
    small = sess.render(sw, sh, cams[0], focal_s, renderer="live")
    cpu_sess = Session(device="cpu")
    cpu_sess.load_snapshot(SNAP)
    t = time.perf_counter()
    small_cpu = cpu_sess.render(sw, sh, cams[0], focal_s, renderer="live")
    err = (small.cpu() - small_cpu).abs()
    ok = (err <= FRAME_TOL["atol"] + FRAME_TOL["rtol"] * small_cpu.abs()).all(dim=-1)
    agree = float(ok.float().mean())
    log(f"[live] {sw}x{sh} card vs CPU ({time.perf_counter() - t:.1f} s on the CPU): "
        f"{100 * agree:.2f} % of pixels within rtol {FRAME_TOL['rtol']} atol "
        f"{FRAME_TOL['atol']}, max abs err {float(err.max()):.3g}, PSNR "
        f"{metrics.psnr(small[..., :3], small_cpu[..., :3]):.2f} dB")
    check(agree >= LIVE_MIN_AGREE, f"live {sw}x{sh}: only {100 * agree:.2f} % of pixels "
                                   f"agree with the CPU frame")
    # composite_chunk's depth takes the first maximum on a tie, on both devices
    w = torch.zeros((4, 16))
    w[1, 3] = w[1, 9] = w[2, 15] = 0.5
    w[3] = 0.25
    check(torch.argmax(w.to(dev), dim=1).cpu().tolist() == torch.argmax(w, dim=1).tolist()
          == [0, 3, 15, 0], "argmax breaks ties differently on the card")

    # -- 7c. quality: the sweep frame against the live frame, three views
    quality = []
    for i, cam in enumerate(cams):
        # through the large tile: per-ray results do not depend on it
        lv = live0 if i == 0 else live_frame(cam, tile=LIVE_BIG_TILE)
        sw_img = frames[i, 1]
        db = metrics.psnr(sw_img[..., :3], lv[..., :3])
        ss = metrics.ssim(sw_img[..., :3], lv[..., :3])
        quality.append((db, ss))
        log(f"[quality] view {i} (axis {axes[i][0]}) sweep vs live, spp 1: PSNR {db:.2f} dB, "
            f"SSIM {ss:.4f}, mean alpha sweep {float(sw_img[..., 3].mean()):.3f} live "
            f"{float(lv[..., 3].mean()):.3f}")
        check(math.isfinite(db) and math.isfinite(ss), "non-finite quality figure")
        check(db > QUALITY_MIN_DB, f"view {i}: sweep vs live PSNR {db:.2f} dB")

    # -- 8. timings: frames (host clock around synchronised frames) and kernels
    def frame(i=0):
        sess.render(WIDTH, HEIGHT, cams[i], FOCAL, spp=1, renderer="sweep")
        torch.cuda.synchronize()

    frame_ms_by_view = []
    for i in range(len(cams)):
        for _ in range(2):
            frame(i)
        ms = []
        for _ in range(7):
            t = time.perf_counter()
            frame(i)
            ms.append(1e3 * (time.perf_counter() - t))
        frame_ms_by_view.append(ms)
    frame_ms = frame_ms_by_view[0]
    args0 = (view, g0["o_c"], g0["eb"], g0["ec"], near, min_t)
    k1_times = [cuda_ms(lambda: shade(g0), 1, warmup=1) for _ in range(10)]
    k1_ms = statistics.median(k1_times)
    k2_ms = k2_axis_ms[g0["axis"]]
    k1_plain_ms = cuda_ms(lambda: shade_volume_plain(
        rows, scale, g0["o"][0], params["rgb_mlp"], resolution=R, n_cascades=K, **acts), 2)
    k2_plain_ms = cuda_ms(lambda: sweep_composite_plain(
        *args0, resolution=R, n_cascades=K, data_flip=g0["flip"]), 2)
    for i, ms in enumerate(frame_ms_by_view):
        log(f"[time] frame 1280x720 spp1 view {i} (axis {axes[i][0]}): median "
            f"{statistics.median(ms):.2f} ms (runs {[round(x, 2) for x in ms]})")
    log(f"[time] K1 shade {k1_ms:.3f} ms (ten timings {min(k1_times):.3f}-{max(k1_times):.3f}; "
        f"plain {k1_plain_ms:.1f} ms); K2 sweep axis {g0['axis']} {k2_ms:.3f} ms "
        f"(plain {k2_plain_ms:.1f} ms)")

    # bounds from this run's inputs: bytes at the HBM rate, operations at the
    # peak of their type; data-dependent work counted as this run needs it.
    # K1: a kept vertex reads its 32-byte row, a culled one only its
    # sentinel field; every output vertex is written; MLP on kept vertices.
    weight_bytes = sum(w.numel() for w in params["rgb_mlp"]) * 2
    k1_bytes = (n_live * 32 + (rows.shape[0] - n_live) * 2 + K * Rv ** 3 * 4 * 2
                + scale.numel() * 4 + 3 * 4 + weight_bytes)
    k1_ops = n_live * K1_FLOPS_PER_VERTEX
    # K2: the distinct texels (4 bf16 channels) that live samples read, the
    # schedule, the gnomonic coordinates and the six f32 output maps
    stats: dict = {}
    sweep_composite(view.flip(1) if g0["flip"] else view, g0["o_c"], g0["eb"], g0["ec"],
                    near, min_t, resolution=R, n_cascades=K, stats=stats)
    k2_samples, k2_texels = int(stats["samples"]), int(stats["texels"])
    k2_bytes = k2_texels * 4 * 2 + K * R * 5 * 4 + (hi + wi) * 4 + hi * wi * 6 * 4
    k2_ops = k2_samples * K2_FLOPS_PER_SAMPLE

    def bound(nbytes, ops, peak):
        tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * ops / peak
        return (tb, "bytes") if tb >= to else (to, "operations")

    k1_bound, k1_by = bound(k1_bytes, k1_ops, BF16_FLOPS)
    k2_bound, k2_by = bound(k2_bytes, k2_ops, F32_FLOPS)
    log(f"[bound] K1 {k1_bytes / 1e9:.3f} GB, {k1_ops / 1e12:.3f} TFLOP -> {k1_bound:.3f} ms "
        f"({k1_by}); K2 {k2_bytes / 1e9:.3f} GB ({k2_texels} of {K * Rv ** 3} texels), "
        f"{k2_samples} samples, "
        f"{k2_ops / 1e9:.1f} GFLOP -> {k2_bound:.3f} ms ({k2_by})")
    frame_med = statistics.median(frame_ms)
    for i, ms in enumerate(frame_ms_by_view):
        med, k2a = statistics.median(ms), k2_axis_ms[axes[i][0]]
        log(f"[where] view {i} (axis {axes[i][0]}): frame {med:.2f} ms = K1 {k1_ms:.2f} + K2 "
            f"{k2a:.2f} + rest {med - k1_ms - k2a:.2f} ms")
    log(f"[done] {time.time() - t_all:.1f} s")

    kernels = [
        {"name": "shade", "route": "cuda", "source": "sienerf_torch/csrc/shade.cu",
         "replaces": REPLACES["shade"], "launches": launches["shade"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None},
        {"name": "sweep", "route": "cuda", "source": "sienerf_torch/csrc/sweep.cu",
         "replaces": REPLACES["sweep"], "launches": launches["sweep"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "ms_by_axis": k2_axis_ms, "channel_planar_ms_by_axis": k2_planar_ms},
    ]
    for name, tag, r in (("gather_rows", "G1", g1_main), ("gather_small", "G2", g2_main)):
        kernels.append(
            {"name": name, "route": "cuda", "source": "sienerf_torch/csrc/gather.cu",
             "replaces": REPLACES[name], "launches": launches_probe[name],
             "max_abs_err": 0.0, "ms": r["ms"], "call_ms": r["call_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"], "shape": r["shape"],
             "ms_by_shape": {x["shape"]: x["ms"] for x in probe if x["name"] == tag}})
    log(json.dumps({"frame_ms": frame_med,
                    "frame_ms_by_view": [statistics.median(ms) for ms in frame_ms_by_view],
                    "bake_s": bake_s, "live_frame_ms": live_med,
                    "live_rounds": live_stats["rounds"],
                    "live_big_tile_ms": statistics.median(big_ms),
                    "sweep_vs_live_psnr_db": [q[0] for q in quality],
                    "sweep_vs_live_ssim": [q[1] for q in quality]}))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
