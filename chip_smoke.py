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
  ray-marched renderer, at 1280x720 (the timed frame at tile 2^17, the
  phase-synchronised one at 640x360; a 320x180 frame at tiles 2^14 and
  2^17 for its tile independence), an 80x45 frame of it against the same
  code on the CPU, and the sweep frames' PSNR and SSIM against the live
  frames (view 0 at 1280x720, views 1 and 2 at 640x360);
- the training path: 55 teacher views of the fox field rendered through
  the sweep (K1, K2) at 1280x720 make an in-memory dataset (50 to train, 5
  held out); a fresh fox-width student (8 levels x 4 features, 2^19 rows,
  aabb_scale 4, a 128^3 x 3 occupancy grid, the error map) trains at 2^18
  samples a step, 16 bundles of 16 steps (the march replayed as CUDA
  graphs); one step of the trained student is held bit for bit to the
  same step with the march launched op by op, each timed; one card step is
  held to the CPU step from the same state and draws at 2^14 samples; the trained
  field's EMA params are baked at R=256 and the held-out views rendered
  through K1 and K2, their PSNR and SSIM against the teacher's frames
  beside those of the untrained student.

- the hybrid path (the fork's mesh + NeRF frame): a geometry scene JSON
  with a code-built sphere of 20,480 triangles in front of the fox, loaded
  through Session.load_file; a 3^3 irradiance probe grid baked from the fox
  as the mesh's ambient light; 1280x720 hybrid sweep frames (mesh pass with
  shadow rays and BRDF shading, then K1 and K2 with the mesh's per-pixel
  t_stop) timed and split by part, held to their plain versions, to the
  live hybrid frame and, at 48x27, to the CPU; the BVH tier on an
  81,920-triangle sphere, 1280x720 frames through Session.render with K3
  (the BVH walk, sienerf_torch/csrc/bvh.cu) launched three times a frame,
  each launch's rays held bit for bit to the plain walk, timed and
  bounded; the trained student saved, loaded back as a scene
  object and rendered bit-equal; and two training bundles from one seed,
  bit-equal.

- the baked gather path: Session.render(renderer="baked") at 1280x720 from
  the fox's R=256 bake and its sidecars, through G2 (32-byte vertex rows)
  and, with fine="brick", G1 (512-byte bricks), both held bit for bit to
  the plain gathers on the frame's own ids and the frames to the plain
  frames; the frame timed, counted and split, against the live frame, its
  knobs at 320x180, a trilinear R=128 bake, 48x27 frames against the CPU;
  and the hybrid frame with the trained student loaded twice as NeRF
  objects, rendered through render_rays_baked.

- the image, SDF and volume modes and mesh export, each at its config's
  full width through Session.load_file / train / render on an input
  built in code: `[image]` a 4096x4096 procedural RGBA image written as a
  half-float EXR (16 levels x 2^24 rows, 2^18 samples a step; PSNR against
  the image before and after 97 steps, peak memory); `[sdf]` an
  81,920-triangle sphere beside a box written as OBJ (2^19 rows, 2^16
  samples, host ground truth; IoU at 64^3 before and after 112 steps,
  1280x720 frames with shadows); `[volume]` a 256^3 shell written as
  .nvdb (144 steps, 1280x720 spp 4 frames of the grid and the network,
  their opacities); `[mesh]` save_mesh at 192^3 of the SDF (OBJ) and of
  the fox (binary PLY with vertex colours and normals) and
  optimise_mesh_step.  Each times its steps (bundles
  of 16, synchronised at their ends) and frames, splits one step and one
  frame by phase, holds one injected step to the CPU, and the SDF and
  volume frames to the CPU at a small size.  None launches K1, K2, G1 or
  G2: the JAX package runs these modes in XLA alone.

- every NeRF configuration and the rest of the port's paths: `[configs]`
  each configs/nerf/*.json at full width from a seeded init on the fox's
  occupancy (an R=128 bake, a 320x180 sweep frame through K1 and K2 against
  the plain frame, K1 against plain on its rows; K1's general path on the
  fox's R=256 rows with one config of each general colour-MLP shape and
  the widest four-layer net it takes, timed beside its bound, and on the
  fox's own 32-64-64-3 beside the tuned path, after a probe of one tile
  through both paths' tensor-core instructions), `[takikawa]` configs/sdf/takikawa.json on the [sdf] mesh (the
  octree at depth 10, steps, IoU, one step against the CPU, a 720p frame),
  `[fine]` the trained student's fine render grid, the 320x180 live frame
  with and without it, and a 32x18 frame through it against the CPU,
  `[triplane]` configs/nerf/tensor.json (one step against the CPU, frames
  with K1 and K2 held to plain), and `[png]` ten training views written as
  PNGs, loaded by Session.load_file, trained and scored by compare_view.

- the trainer's optional learners, `[learners]`, on the trained student
  at full width: engine A (per-camera se(3) deltas, focal, exposure, a
  32x32 distortion map, a 128x256 envmap, depth supervision on the
  teacher's depth, the near-density regulariser, rolling shutter) and
  engine B (16 latent codes a view, a 48-input colour MLP), each with one
  injected step held to the CPU (every leaf's gradient), a timed bundle of
  4 steps at 2^18 samples, an R=256 bake and 720p frames: engine A's
  sweep frame through K1 and K2 with the envmap behind, bit-equal bundles;
  engine B's through the plain shade and K2 (K1 never launches), K2 held
  to plain, its baked frames through G2 with view 0's and view 3's code,
  a small live frame against the CPU; the five non-pinhole lenses' 720p
  rays against the CPU, a 320x180 live frame through the OpenCV lens, a
  distortion-mode frame, a motion-blurred Session.render against the CPU;
  and the two-phase trainer's deep bundle, its switch and a step held to
  the CPU.

- the corner table layout and the front-ends, inside `[png]`'s directory:
  `[corner]` a corner-layout configs/nerf/base.json at full width (16 x 2
  levels, 2^19 vertex rows) on the training views (a timed bundle beside
  the cell student's, its hash encode timed, a step held to the CPU, two
  bundles bit-equal), exported as .ingp, reloaded by Session.load_snapshot,
  trained on, and served as a 720p sweep frame through K1 and K2 against
  plain; `[frontends]` viewer.orbit_benchmark through the sweep,
  render_view foveated (live, and baked through G2) against the CPU,
  viewer.make_server on 127.0.0.1 port 0 answering one frame, a Testbed
  screenshot, and the CLI twin sienerf_torch.run.main on the [png] scene
  (train, snapshot, eval, a baked screenshot, an orbit video).

- the multi-device paths, `[multi]`, on max(2, cards) ranks, one process a
  rank (sienerf_torch/parallel/mesh.py): NCCL with a card a rank, or on one
  card two ranks sharing it through gloo. Each rank loads the fox and
  bakes R=256; the sharded 720p sweep frame (K1 on each rank's vertex
  planes, K2 on its slice of the slab schedule) against the one-device
  frame at min transmittance 0, the sharded 320x180 live and baked (G2)
  frames against render_frame and render_frame_baked, K1 on a plane range
  and K2 on a schedule range (with the best weight) against their plain
  versions, each frame timed; the data-parallel trainer on a PNG scene of
  the fox's sweep views (a fox-width net, the 2^18-sample batch's rays
  split over the ranks): one sharded step bit-equal to rank 0's
  one-process mean of the per-shard gradients, a timed sharded bundle
  beside a one-rank bundle, the gradient mean timed, the replicas'
  bits equal, two sharded bundles from one seed bit-equal. K1, K2 and G2
  must launch on every rank. `python3 chip_smoke.py --phase multi` builds
  the kernels and runs this phase alone.

It builds every kernel from the sources in the checkout, holds each against
its plain PyTorch version on the card, checks the sweep frames against the
plain-version frames, counts the kernel launches of each path, and times
frames and kernels.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase multi   # the build, then [multi] alone

Exits non-zero, with no result printed, on any failed check, without a
CUDA device, or outside a checkout of the repo.  The last line of stdout is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import dataclasses
import re
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
LIVE_SMALL = (80, 45)  # the live frame that is held to the CPU run
# pixels of that frame that may leave FRAME_TOL: exp2 / log2 / exp differ in
# the last bit between the card and the CPU, which can move one sample of a
# ray across a voxel boundary
LIVE_MIN_AGREE = 0.99
LIVE_BIG_TILE = 1 << 17
# the live frame's tile independence, checked at a small size with a tile
# that many rays refill
LIVE_SMALL_TILE_CHECK, LIVE_SMALL_TILE = (320, 180), 1 << 14
LIVE_SPLIT_FRAME = (640, 360)  # the phase-synchronised live frame (1280x720 until PR 12)
QUALITY_MIN_DB = 15.0  # a mismatched network config renders fog at ~11 dB
QUALITY_SMALL = (640, 360)  # views 1 and 2's sweep vs live frames
# the training phase: teacher views on a Fibonacci sphere around the cube
# centre; every TRAIN_HOLD_EVERY-th (from the middle of the first run) is
# held out, so that the held-out views spread over the sphere
TRAIN_VIEWS, TRAIN_HOLD_EVERY, TRAIN_RADIUS = 55, 11, 1.8
TRAIN_BATCH = 1 << 18
TRAIN_SPP = 8  # sweep passes (subpixel offset and slab phase) of a view
# 16 bundles; fewer (never below 8) only past TRAIN_BUDGET_S of training.
# On H100 machines 16 bundles took 199-275 s, and the slowest host 316 s for
# 15; the held-out check needs all 16 (15 gave 15.04 dB against its 15 dB),
# so the budget sits above the slowest host, well inside the script's limit
TRAIN_BUNDLES, TRAIN_MIN_BUNDLES, TRAIN_BUDGET_S = 16, 8, 400.0
TRAIN_CHECK_BATCH = 1 << 14  # the card step held to the CPU step ...
TRAIN_CHECK_VIEWS = 5  # ... on the first training views
TRAIN_MIN_GAIN_DB = 5.0  # held-out PSNR over the untrained student's
# card vs CPU step: the gradient tolerances of tests/test_torch_hashgrad.py
STEP_MLP_TOL = dict(rtol=1e-2, atol=1e-3)
STEP_MAX_SHARE = 0.02  # of each leaf's largest gradient
# the loss: the card sums each MLP layer in another order than the CPU, so a
# hidden value on a bf16 rounding boundary can round the other way; on a
# trained fox student those flips moved the loss by 7.6e-5 to 4.1e-4
# relative on an H100, so the raw check stays at 1e-3 ...
STEP_LOSS_RTOL = 1e-3
# ... and the flips must account for the whole difference: once the card's
# bf16 roundings are put into the CPU step, the two losses meet at the
# tolerance of the rest of the arithmetic (the f32 ulps of exp and log1p)
STEP_FLIP_RTOL = 1e-5
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
# the hybrid phase: the camera of view 0, a sphere of 20,480 triangles 35 %
# of the way to the cube centre, the probe box of the hybrid example
HYBRID_EYE, HYBRID_SPHERE_AT, HYBRID_RADIUS = (2.1, 0.5, 0.6), 0.35, 0.12
PROBE_BOX = ([0.3, 0.2, 0.2], [1.2, 0.9, 0.9])
HYBRID_SMALL = (320, 180)
# timed 720p hybrid frames (3.59-3.60 s each on an H100, within 0.1 % of one
# another): one, after the first and a warm-up
HYBRID_TIMED = 1
# timed 720p frames of the 81,920-triangle sphere (the BVH tier, K3)
BVH_TIMED = 3
# kernel frame vs plain frame: a NeRF fragment whose depth lies within
# rounding of the mesh's can fall on either side of the depth test
HYBRID_MIN_AGREE = 0.999
HIT_MIN_AGREE = 0.999  # BVH vs brute hit masks (edge hits round apart)
K1_FLOPS_PER_VERTEX = 2 * (32 * 64 + 64 * 64 + 64 * 3)  # the colour MLP
# the baked phase: 720p frames timed as the median of BAKED_TIMED after two
# warm-ups; the knobs at BAKED_SMALL against the default knobs (cull coarse,
# fine row): cull=brick and fine=brick at the JAX package's cull tolerances
# (tests/test_baked.py:392-398: 5e-2 on rgb, 8e-2 on opacity, mean rgb
# error under 5e-3).  cull=fine drops the candidates whose own vertex is
# below the live threshold, which the coarse cover keeps and composites, so
# on the fox a few pixels move by up to ~0.06 in rgb (0.0541 on the card,
# 38 of 57,600 pixels above 5e-2 at R=128 on the CPU, the JAX package's
# frames likewise); it is held to the mean and opacity tolerances and to
# 0.1 in rgb.  The trilinear cull against no cull: above 35 dB on an R=128
# bake.  The scout and distance-field advances are printed against the DDA
# and held to the CPU: on the fox (cone stepping, 3 cascades) the JAX
# package's own frames sit 17.9-21.4 dB from its DDA frame at R=64 (its
# 30 dB check is of a one-cascade scene without cone stepping), and the
# port's equal them (tests/test_torch_baked.py)
BAKED_TIMED = 1
BAKED_SMALL = (320, 180)
BAKED_MIN_DB = 20.0  # baked vs live at 720p: the sweep's level
CULL_TOL = dict(rgb=5e-2, opacity=8e-2, mean_rgb=5e-3)
CULL_FINE_MAX_RGB = 0.1
TRILINEAR_MIN_DB, TRILINEAR_RES = 35.0, 128
# the baked hybrid: the student loaded twice, at two centres behind the
# sphere; tile 2^18 rays (per-ray results do not depend on it)
HYBRID_NERF_CENTERS = ([0.0, 0.0, 0.0], [-0.15, 0.3, 0.2])
HYBRID_BAKED_TILE, HYBRID_BAKED_TIMED = 1 << 18, 1
HYBRID_BAKED_SMALL = (160, 90)  # its frame against the live hybrid
HYBRID_CPU_SMALL = (48, 27)  # the live hybrid frame held to the CPU
BAKED_CPU_SMALL = (48, 27)  # [baked]'s frames held to the CPU
GATHER_REPS = 2  # the gather probe's bursts a shape (5 until PR 11, 3 until PR 12)
K2_FLOPS_PER_SAMPLE = 30  # affine map, texel select, alpha (one exp), carry
# Slice F: the image, SDF and volume modes at their configs' full width and
# mesh export, each input built in code (the reference's image, meshes and
# .nvdb cloud are not in the repo).  Depths are cut so that the four phases
# take under 150 s together: image 6 bundles of 16 steps; SDF 6 bundles
# (its host ground truth sets the pace, PERF.md section 5); volume 8 bundles;
# each phase then times one more, phase-synchronised, step or bundle
IMAGE_RES, IMAGE_BUNDLES = 4096, 6
IMAGE_MIN_GAIN_DB = 8.0  # PSNR over the untrained network's (tests/test_image_mode.py)
MODE_CHECK_BATCH = 1 << 14  # the card step held to the CPU step ...
MODE_STEP_LOSS_RTOL = 1e-4  # ... at the CPU tests' loss tolerance
SDF_SPHERE_SUBDIV, SDF_BUNDLES, SDF_IOU_RES = 6, 4, 64
SDF_MIN_IOU_GAIN = 0.15  # IoU over the untrained network's
SDF_EYE, SDF_SMALL = (1.3, 0.9, -0.5), (160, 90)
VOLUME_RES, VOLUME_BUNDLES, VOLUME_SPP = 256, 8, 4
VOLUME_EYE, VOLUME_FOCAL, VOLUME_SMALL = (0.5, 0.5, -1.5), 1600.0, (64, 36)
MESH_RES, MESH_OPT_STEPS = 192, 3  # 256^3 until PR 12
# every configs/nerf/*.json at full width from a seeded init on the fox's
# occupancy: a bake at CONFIG_BAKE_RES and CONFIG_SMALL sweep frames; K1's
# general path timed on the fox's R=256 rows with one config of each of the
# general colour-MLP shapes of configs/nerf/ (32-3, 32-64-3, 32-64x3-3,
# 32-128x2-3), and with the widest four-layer net it takes, 32-128x4-3,
# from seeded weights (no config has it: frequency.json's and none.json's
# 128 x 4 is their density MLP, their colour MLP the fox's 32-64-64-3)
CONFIG_BAKE_RES, CONFIG_SMALL = 128, (320, 180)
CONFIG_TIMED = ("base_0layer", "small", "base_3layer", "big")
K1_WIDEST = ((32, 128), (128, 128), (128, 128), (128, 128), (128, 3))
# a colour MLP the general kernel cannot hold (above width 256): the wide
# kernel's check on the fox's rows
K1_WIDE = ((32, 512), (512, 3))
# the Takikawa SDF (configs/sdf/takikawa.json) on the [sdf] phase's mesh;
# the fine render grid; the PNG dataset of the [train] views
TAKIKAWA_BUNDLES = 4
FINE_FACTOR, FINE_FRAME = 4, (320, 180)  # the fine grid's factor, its live frames (640x360 until PR 12)
FINE_CPU_SMALL = (32, 18)  # its frame held to the CPU
PNG_VIEWS, PNG_STEPS, PNG_COMPARE_DOWNSCALE = 10, 4, 4  # 16 steps and downscale 2 until PR 12
CORNER_BAKE_RES = 128  # the imported corner field's sweep frame
CORNER_TIMED_STEPS = 4  # its timed bundle
FRONT_ORBIT_FRAMES = 8  # viewer.orbit_benchmark's frames at 640x360
FRONT_FOVEATION, FRONT_FOVEATED = 4.0, (320, 180)  # render_view's foveated views
FRONT_CLI_LOG2_ROWS = 14  # the CLI twin's net: [png]'s with 2^14 table rows
# the CLI twin's eval views and video frames
FRONT_CLI_EVAL_VIEWS, FRONT_CLI_VIDEO_FRAMES = 1, 2
# the determinism checks' bundles: 2 steps each (every sum of a step runs
# in each; more only repeat them; 4 until PR 12)
DETERMINISM_STEPS = 2
# frames of the hybrid, baked and fine phases held to the CPU
CPU_SMALL = (80, 45)
# the trainer's learners (Slice C2b) on the [train] student at full width:
# engine A (cameras, focal, exposure, a 32x32 distortion map, a 128x256
# envmap, depth, near-density, rolling shutter), engine B (16 latent codes
# a view: a 48-input colour MLP), the lenses and motion blur, the two-phase
# path.  Small frames held to the CPU: engine B's live frame and the
# motion-blurred Session.render (spp 4)
LEARN_DIST_RES, LEARN_ENVMAP, LEARN_CODES = 32, (128, 256), 16
LEARN_ROLLING_SHUTTER = (0.0, 0.0, 0.5, 0.1)
LEARN_DEPTH_LAMBDA, LEARN_NEAR_REG = 0.1, 1e-3
LEARN_SMALL, MOTION_SMALL, MOTION_SPP = (64, 36), (32, 18), 4
LEARN_TIMED_STEPS = 4  # the timed bundles of engines A, B and D (16 until PR 12)
# lens params: OpenCV k1 k2 p1 p2; fisheye k1..k4; F-theta r0..r4, resx, resy
LENS_PARAMS = {"opencv": (-0.12, 0.03, 1e-3, -2e-3), "opencv_fisheye": (0.05, -0.01, 2e-3, -1e-3),
               "ftheta": (0.0, 1.2e-3, 0.0, 0.0, 0.0, 1280.0, 720.0), "latlong": (),
               "equirectangular": ()}
RAY_TOL = dict(rtol=1e-5, atol=1e-5)  # card rays vs CPU rays (f32 ulps of trig)
# the multi-device paths, [multi]: max(2, cards) ranks (NCCL with a card a
# rank; on one card two ranks share it through gloo); frames of view 0
# against the one-device frames (the sweep at min transmittance 0 within
# the JAX package's sharded-sweep tolerance), the trainer on a PNG scene of
# MULTI_VIEWS sweep views of the fox at MULTI_VIEW_RES
MULTI_SMALL = (320, 180)  # the sharded live and baked frames
MULTI_SWEEP_TOL, MULTI_DEPTH_TOL = dict(rtol=0.0, atol=1e-4), dict(rtol=0.0, atol=1e-3)
MULTI_LIVE_TILE = 1 << 15  # rays a tile of a rank's live frame
MULTI_VIEWS, MULTI_VIEW_RES = 12, (640, 360)
MULTI_TIMED_STEPS = 4  # the timed sharded and one-rank bundles
MULTI_TIMEOUT_S = 900.0


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


T_START = time.time()


def log(msg: str) -> None:
    """A line of the run's log; a phase's lines ("[name] ...") carry the
    seconds since the script started."""
    if msg.startswith("["):
        msg = f"{time.time() - T_START:7.1f}s {msg}"
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


def fibonacci_cameras(n: int, radius: float):
    """n NGP camera matrices on a Fibonacci sphere of `radius` around the
    cube centre, each looking at it."""
    import numpy as np

    from sienerf_torch.utils.camera import look_at_matrix

    c = np.full(3, 0.5)
    golden = math.pi * (3.0 - math.sqrt(5.0))
    cams = []
    for i in range(n):
        y = 1.0 - 2.0 * (i + 0.5) / n
        r = math.sqrt(1.0 - y * y)
        eye = c + radius * np.array([r * math.cos(golden * i), y, r * math.sin(golden * i)])
        cams.append(look_at_matrix(eye, c))
    return cams


def rounding_flips(ceng, peng, state_c, cpu_state, draws, k, iters, dev) -> dict:
    """Show value by value where the card's and the CPU's loss of one step
    part.  The MLP inputs (encoding features and hidden units) whose bf16
    rounding differs between the two, and each one's first-order effect on
    the CPU loss (its gradient times the difference); then the CPU loss
    recomputed with the card's rounded values put in, and with the card's
    f32 MLP outputs put in as well (the other place where the two devices'
    summation orders part).  Fails unless the loss with the card's
    roundings meets the card's within STEP_FLIP_RTOL."""
    import torch

    from sienerf_torch.ops.mlp import tap_roundings
    from sienerf_torch.ops.optim import tree_map
    from sienerf_torch.tracing import PhaseClock

    def loss_of(eng, state, d, device, grad=False, replace=None):
        params = tree_map(lambda x: x.detach().requires_grad_(grad), state["params"])
        with torch.enable_grad() if grad else torch.no_grad(), \
                tap_roundings(replace) as tap:
            loss, _ = eng._loss_for_batch(params, state["occ"]["bitfield"], d,
                                          state.get("emap"), k, iters, PhaseClock(None, device))
            g = torch.autograd.grad(loss, tap.seen) if grad else None
        return float(loss), [v.detach() for v in tap.seen], tap.kinds, g

    cpu = torch.device("cpu")
    lc, seen_c, kinds, _ = loss_of(ceng, state_c, tree_map(lambda x: x.to(dev), draws), dev)
    lp, seen_p, _, grads = loss_of(peng, cpu_state, draws, cpu, grad=True)
    seen_c = [v.cpu() for v in seen_c]
    layers, effect = [], []
    for i, (c, p, g, kind) in enumerate(zip(seen_c, seen_p, grads, kinds)):
        if kind != "rounded":
            continue
        flip = c != p
        e = (g * (c - p))[flip]
        effect.append(e)
        layers.append({"tap": i, "values": c.numel(), "flipped": int(flip.sum()),
                       "first_order": float(e.sum())})
    all_e = torch.cat(effect)
    top = all_e.abs().topk(min(5, all_e.numel())).values.tolist() if all_e.numel() else []
    rounded_only = [v if kind == "rounded" else None for v, kind in zip(seen_c, kinds)]
    li = loss_of(peng, cpu_state, draws, cpu, replace=rounded_only)[0]
    lo = loss_of(peng, cpu_state, draws, cpu, replace=seen_c)[0]
    out = {"loss_card": lc, "loss_cpu": lp, "loss_cpu_with_card_roundings": li,
           "loss_cpu_with_card_roundings_and_outputs": lo,
           "rel_card_cpu": abs(lc / lp - 1), "rel_card_injected": abs(lc / li - 1),
           "rel_card_injected_outputs": abs(lc / lo - 1),
           "first_order_sum": float(all_e.sum()), "largest_effects": top, "layers": layers}
    log("[train] bf16 roundings, card vs CPU step: "
        + ", ".join(f"tap {x['tap']} {x['flipped']} of {x['values']} flipped "
                    f"(first-order {x['first_order']:.3e})" for x in layers))
    log(f"[train] loss card {lc:.9f}, CPU {lp:.9f} (relative {out['rel_card_cpu']:.3e}; "
        f"first-order sum of the flips {out['first_order_sum']:.3e} against the difference "
        f"{lc - lp:.3e}); CPU with the card's roundings {li:.9f} (relative to the card "
        f"{out['rel_card_injected']:.3e}), and with the card's f32 MLP outputs too {lo:.9f} "
        f"({out['rel_card_injected_outputs']:.3e}); largest single effects "
        f"{[f'{x:.2e}' for x in top]}")
    check(out["rel_card_injected"] <= STEP_FLIP_RTOL,
          f"card step: with the card's bf16 roundings the CPU loss is still "
          f"{out['rel_card_injected']:.2e} from the card's (over {STEP_FLIP_RTOL})")
    return out


def train_phase(sess, dev, cuda_ms) -> dict:
    """Teacher views -> dataset -> train a student on the card -> check one
    card step against the CPU step -> bake and render the held-out views
    through K1 and K2.  Returns the phase's numbers."""
    import numpy as np
    import torch

    from sienerf_torch import metrics
    from sienerf_torch.engines.nerf import TRAIN_PHASES, NerfEngine
    from sienerf_torch.io.nerf_dataset import NerfDataset
    from sienerf_torch.ops import hashgrid
    from sienerf_torch.ops.optim import tree_leaves, tree_map
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel
    from sienerf_torch.session import Session

    out = {}
    # -- teacher views through K1 and K2: straight colour and alpha
    cams = fibonacci_cameras(TRAIN_VIEWS, TRAIN_RADIUS)
    shade_volume.launches = sweep_composite_kernel.launches = 0
    t = time.perf_counter()
    teacher = [sess.render(WIDTH, HEIGHT, c, FOCAL, spp=TRAIN_SPP, renderer="sweep")
               for c in cams]
    torch.cuda.synchronize()
    out["teacher_launches"] = {"shade": shade_volume.launches,
                               "sweep": sweep_composite_kernel.launches}
    log(f"[train] {TRAIN_VIEWS} teacher views {WIDTH}x{HEIGHT} through the sweep in "
        f"{time.perf_counter() - t:.1f} s, launches {out['teacher_launches']}, mean alpha "
        f"{float(torch.stack([f[..., 3].mean() for f in teacher]).mean()):.3f}")
    check(all(n == TRAIN_VIEWS * TRAIN_SPP for n in out["teacher_launches"].values()),
          "teacher views: K1 or K2 was not launched once a pass")
    held_ids = [i for i in range(TRAIN_VIEWS) if i % TRAIN_HOLD_EVERY == TRAIN_HOLD_EVERY // 2]
    train_ids = [i for i in range(TRAIN_VIEWS) if i not in held_ids]
    n_train = len(train_ids)
    images = np.empty((n_train, HEIGHT, WIDTH, 4), np.float32)
    for j, i in enumerate(train_ids):
        a = teacher[i][..., 3:4]
        straight = torch.where(a > 0, teacher[i][..., :3] / torch.clamp(a, min=1e-6), 0.0)
        images[j] = torch.cat([straight, a], dim=-1).cpu().numpy()
    held = [teacher[i][..., :3].contiguous() for i in held_ids]
    del teacher
    log(f"[train] {n_train} training views, views {held_ids} held out")
    ds = NerfDataset(images=images,
                     xforms=np.stack([cams[i] for i in train_ids]).astype(np.float32),
                     focal_lengths=np.tile(np.asarray(FOCAL, np.float32), (n_train, 1)),
                     principal_points=np.full((n_train, 2), 0.5, np.float32),
                     resolution=(WIDTH, HEIGHT), aabb_scale=4.0)
    sess._baked = None  # the teacher's bake is not needed any more
    torch.cuda.empty_cache()

    # -- the student, on the card
    t = time.perf_counter()
    eng = NerfEngine.create(sess.network_config, ds, train_batch_size=TRAIN_BATCH, device=dev)
    state = eng.init(0)
    state0 = state
    gen = torch.Generator(device=dev).manual_seed(0)
    g = eng.net.grid
    log(f"[train] student: grid {g.n_levels}x{g.n_features_per_level}, 2^"
        f"{g.log2_hashmap_size} rows, aabb {ds.aabb_scale}, occupancy {eng.occ.grid_size}^3 x "
        f"{eng.occ.n_cascades}, batch {eng.train_n_rays} x {eng.train_k}, error map "
        f"{eng.use_error_map}; create + init {time.perf_counter() - t:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, bundles = [], [], []
    split = None
    t_train = time.perf_counter()
    for b in range(TRAIN_BUNDLES):
        stats = {"sync_phases": b == TRAIN_BUNDLES // 2}
        t = time.perf_counter()
        state, loss, cnt = eng.train_bundle(state, gen, stats)
        loss, cnt = float(loss), float(cnt)  # synchronises
        ms = 1e3 * (time.perf_counter() - t) / eng.grid_interval
        occ = float(state["occ"]["bitfield"].float().mean())
        losses.append(loss)
        if stats["sync_phases"]:
            split = {k: 1e3 * v / eng.grid_interval for k, v in stats["phase_s"].items()}
        else:
            step_ms.append(ms)
        bundles.append({"loss": loss, "n_rays": stats["n_rays"], "k": stats["k"],
                        "samples_per_ray": cnt, "occupancy": occ, "ms_per_step": ms,
                        "phase_synced": stats["sync_phases"]})
        log(f"[train] bundle {b}: loss {loss:.5f}, n_rays {stats['n_rays']}, k {stats['k']} "
            f"(march iterations {stats['iters']}), {cnt:.1f} samples a ray, occupancy "
            f"{occ:.4f}, {ms:.1f} ms a step" + (" (phases synchronised)"
                                                 if stats["sync_phases"] else ""))
        check(math.isfinite(loss), f"bundle {b}: non-finite loss")
        if b + 1 >= TRAIN_MIN_BUNDLES and time.perf_counter() - t_train > TRAIN_BUDGET_S \
                and b + 1 < TRAIN_BUNDLES:
            log(f"[train] over {TRAIN_BUDGET_S:.0f} s: stopping after {b + 1} bundles")
            break
    out["steps"] = int(state["step"])
    out["bundles"] = bundles
    out["ms_per_step"] = statistics.median(step_ms)
    out["loss_first_last"] = [losses[0], losses[-1]]
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[train] {out['steps']} steps in {time.perf_counter() - t_train:.1f} s: median "
        f"{out['ms_per_step']:.1f} ms a step (unsynchronised bundles; all "
        f"{[round(x, 1) for x in step_ms]}), peak memory {out['peak_mem_gb']:.2f} GB")
    if split:
        out["phase_ms_per_step"] = split
        log(f"[train] where a step's time goes (bundle {TRAIN_BUNDLES // 2}, the device "
            f"synchronised after each phase, {sum(split.values()):.1f} ms a step): "
            + ", ".join(f"{k} {split[k]:.2f} ms" for k in TRAIN_PHASES))
    check(losses[-1] < 0.5 * losses[0],
          f"training: last bundle's loss {losses[-1]:.5f} is not under half the first's "
          f"{losses[0]:.5f}")
    check(bundles[-1]["occupancy"] < 1.0, "training: the occupancy grid did not carve")

    # the hash grid alone at the batch size: forward and backward
    n = TRAIN_BATCH
    pos = torch.rand((n, 3), generator=gen, device=dev)
    table = state["params"]["grid"].detach().requires_grad_(True)
    gout = torch.randn((n, g.n_output_dims), generator=gen, device=dev)
    fwd_ms = cuda_ms(lambda: hashgrid.hashgrid_encode(g, table, pos), 5)
    enc = hashgrid.hashgrid_encode(g, table, pos)
    both_ms = cuda_ms(lambda: torch.autograd.grad(hashgrid.hashgrid_encode(g, table, pos),
                                                  table, gout), 5)
    out["hash_fwd_ms"], out["hash_bwd_ms"] = fwd_ms, both_ms - fwd_ms

    def parent_backward():
        # the backward as it was before it summed in a fixed order: one
        # index_add_ of each level's bf16-rounded contributions
        idx, w = hashgrid._geometry_cell(g, pos)
        gl = gout.reshape(n, g.n_levels, g.n_features_per_level)
        C, F = 1 << g.n_dims, g.n_features_per_level
        d = torch.zeros((g.n_levels, g.table_size, C * F), device=dev)
        for lv in range(g.n_levels):
            contrib = (w[:, lv, :, None] * gl[:, lv, None, :]).reshape(n, C * F)
            d[lv].index_add_(0, idx[:, lv], contrib.to(torch.bfloat16).float())
        return d

    new_bwd = cuda_ms(lambda: hashgrid.HashGridEncode.backward(
        type("Ctx", (), {"saved_tensors": (table, pos), "config": g,
                         "needs_input_grad": (True, False)})(), gout), 5)
    old_bwd = cuda_ms(parent_backward, 5)
    out["hash_bwd_alone_ms"], out["hash_bwd_index_add_ms"] = new_bwd, old_bwd
    log(f"[train] hash grid at {n} samples: forward {fwd_ms:.3f} ms, backward "
        f"{both_ms - fwd_ms:.3f} ms (forward + backward {both_ms:.3f} ms); the backward alone "
        f"{new_bwd:.3f} ms in a fixed order against {old_bwd:.3f} ms for the parent's "
        f"index_add_ (call times: the fixed order synchronises with the host)")
    del pos, table, gout, enc

    # -- the trained student's next step with its march replayed as CUDA
    # graphs (the default) and launched op by op: bit-equal, each timed
    from sienerf_torch.ops import raymarch
    n_rays, k, iters = eng._phase_geometry()
    draws = eng.draw_step(torch.Generator(device=dev).manual_seed(2), n_rays, int(state["step"]))
    by_mode = {}
    for graphed in (True, False, True):
        raymarch.GRAPHED_MARCH = graphed
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss_g, grads_g, _ = eng.loss_and_grads(state, draws, k, iters)
        torch.cuda.synchronize()
        by_mode[graphed] = (1e3 * (time.perf_counter() - t), loss_g,
                            [x.clone() for x in tree_leaves(grads_g)])
    raymarch.GRAPHED_MARCH = True
    same = (torch.equal(by_mode[True][1], by_mode[False][1])
            and all(torch.equal(a, b) for a, b in zip(by_mode[True][2], by_mode[False][2])))
    out["graphed_step_ms"], out["eager_step_ms"] = by_mode[True][0], by_mode[False][0]
    log(f"[train] one step at {n_rays} rays x k {k} ({iters} march iterations): the march as "
        f"CUDA graphs {by_mode[True][0]:.1f} ms, op by op {by_mode[False][0]:.1f} ms; loss and "
        f"gradients bit-equal: {same}")
    check(same, "the graphed march's step differs from the op-by-op march's")
    del by_mode, grads_g, draws

    # -- one card step against the CPU step, same state and draws (on the
    # first TRAIN_CHECK_VIEWS training views: the engines' set-up is per view)
    t = time.perf_counter()
    few = dataclasses.replace(ds, images=ds.images[:TRAIN_CHECK_VIEWS],
                              xforms=ds.xforms[:TRAIN_CHECK_VIEWS],
                              focal_lengths=ds.focal_lengths[:TRAIN_CHECK_VIEWS],
                              principal_points=ds.principal_points[:TRAIN_CHECK_VIEWS])
    ceng = NerfEngine.create(sess.network_config, few, train_batch_size=TRAIN_CHECK_BATCH,
                             device=dev)
    peng = NerfEngine.create(sess.network_config, few, train_batch_size=TRAIN_CHECK_BATCH,
                             device="cpu")
    ceng._mean_samples = peng._mean_samples = eng._mean_samples
    n_rays, k, iters = ceng._phase_geometry()
    draws = peng.draw_step(torch.Generator().manual_seed(1), n_rays, int(state["step"]))
    cpu_state = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, state)
    # the error map of the first views only
    cpu_state["emap"] = dict(cpu_state["emap"],
                             error=cpu_state["emap"]["error"][:TRAIN_CHECK_VIEWS])
    state_c = dict(state, emap=dict(state["emap"],
                                    error=state["emap"]["error"][:TRAIN_CHECK_VIEWS]))
    loss_c, grads_c, aux_c = ceng.loss_and_grads(
        state_c, tree_map(lambda x: x.to(dev), draws), k, iters)
    loss_p, grads_p, aux_p = peng.loss_and_grads(cpu_state, draws, k, iters)
    same_counts = float((aux_c[0].cpu() == aux_p[0]).float().mean())
    log(f"[train] card step vs CPU step at {n_rays} rays x k {k} ({int(aux_p[0].sum())} "
        f"samples; {time.perf_counter() - t:.1f} s): loss {float(loss_c):.8f} vs "
        f"{float(loss_p):.8f} (relative {abs(float(loss_c) / float(loss_p) - 1):.2e}), "
        f"{100 * same_counts:.2f} % of rays with the same samples")
    out["flips"] = rounding_flips(ceng, peng, state_c, cpu_state, draws, k, iters, dev)
    check(abs(float(loss_c) - float(loss_p)) <= STEP_LOSS_RTOL * abs(float(loss_p)),
          f"card step: loss differs from the CPU step beyond rtol {STEP_LOSS_RTOL}")
    worst = {}
    for name in ("density_mlp", "rgb_mlp", "grid"):
        leaves_c = grads_c[name] if name != "grid" else [grads_c[name]]
        leaves_p = grads_p[name] if name != "grid" else [grads_p[name]]
        for i, (a, b) in enumerate(zip(leaves_c, leaves_p)):
            a = a.cpu()
            err = float((a - b).abs().max())
            share = err / max(float(b.abs().max()), 1e-30)
            worst[f"{name}[{i}]"] = share
            check(share <= STEP_MAX_SHARE,
                  f"card step: {name}[{i}] gradient off by {100 * share:.2f} % of its max")
            if name != "grid":
                check(bool(torch.allclose(a, b, **STEP_MLP_TOL)),
                      f"card step: {name}[{i}] gradient outside rtol 1e-2 atol 1e-3")
    log("[train] card vs CPU gradients, max |diff| / max |grad|: "
        + ", ".join(f"{k} {100 * v:.3f} %" for k, v in worst.items()))
    out["card_vs_cpu_grad_share"] = worst
    del ceng, peng, cpu_state, state_c, grads_c, grads_p

    # -- serve the trained field: bake the EMA params, render the held-out
    # views through K1 and K2, against the teacher's frames
    cams_held = [cams[i] for i in held_ids]
    res = {}
    for tag, st in (("untrained", state0), ("trained", state)):
        student = Session(device=dev)
        student.engine, student.state, student.network_config = eng, st, sess.network_config
        shade_volume.launches = sweep_composite_kernel.launches = 0
        t = time.perf_counter()
        student.bake(resolution=BAKE_RES)
        frames = [student.render(WIDTH, HEIGHT, c, FOCAL, spp=TRAIN_SPP, renderer="sweep")
                  for c in cams_held]
        torch.cuda.synchronize()
        launches = {"shade": shade_volume.launches, "sweep": sweep_composite_kernel.launches}
        if tag == "trained":  # two training views, beside the held-out ones
            fit = [float(metrics.psnr(student.render(
                WIDTH, HEIGHT, cams[i], FOCAL, spp=TRAIN_SPP, renderer="sweep")[..., :3],
                torch.from_numpy(images[j, ..., :3] * images[j, ..., 3:]).to(dev)))
                for j, i in list(enumerate(train_ids))[:2]]
            out["train_view_psnr_db"] = fit
            log(f"[train] trained student on training views {train_ids[:2]}: PSNR vs "
                f"teacher {[round(x, 2) for x in fit]} dB")
        dbs = [float(metrics.psnr(f[..., :3], h)) for f, h in zip(frames, held)]
        ss = [float(metrics.ssim(f[..., :3], h)) for f, h in zip(frames, held)]
        res[tag] = {"psnr_db": dbs, "ssim": ss, "launches": launches}
        log(f"[train] {tag} student (step {int(st['step'])}): bake R={BAKE_RES} and "
            f"{len(frames)} held-out frames in {time.perf_counter() - t:.1f} s, launches "
            f"{launches}; PSNR vs teacher {[round(x, 2) for x in dbs]} dB (mean "
            f"{statistics.mean(dbs):.2f}), SSIM {[round(x, 4) for x in ss]}")
        for f in frames:
            check(f.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(f).all()),
                  f"{tag} student: bad frame")
        check(all(n == len(frames) * TRAIN_SPP for n in launches.values()),
              f"{tag} student: K1 or K2 not launched once a pass of a held-out frame")
        del student, frames
    mean_db = statistics.mean(res["trained"]["psnr_db"])
    check(mean_db >= QUALITY_MIN_DB, f"held-out PSNR {mean_db:.2f} dB under {QUALITY_MIN_DB}")
    check(mean_db >= statistics.mean(res["untrained"]["psnr_db"]) + TRAIN_MIN_GAIN_DB,
          f"held-out PSNR {mean_db:.2f} dB is not {TRAIN_MIN_GAIN_DB} dB over the untrained "
          f"student's")
    out["heldout"] = res
    out["heldout_psnr_db"] = mean_db
    out["path_launches"] = res["trained"]["launches"]
    # the trained student as a native snapshot, for the hybrid phase's
    # round trip
    student = Session(device=dev)
    student.engine, student.state, student.network_config = eng, state, sess.network_config
    student.training_step = int(state["step"])
    out["snapshot"] = Path(tempfile.mkdtemp()) / "student.snap"
    t = time.perf_counter()
    student.save_snapshot(out["snapshot"], level=0)  # 2 GB of floats: stored
    log(f"[train] student saved to a native snapshot ({out['snapshot'].stat().st_size / 1e6:.1f} "
        f"MB) in {time.perf_counter() - t:.1f} s")
    out["engine"], out["state"], out["dataset"] = eng, state, ds
    return out


def _write_scene(tmp: Path, name: str, tris, center, radius, nerf: Path | None = None) -> Path:
    """A geometry scene JSON in `tmp`: one sphere mesh (written to an OBJ)
    of `radius` at `center`, and a NeRF object at the origin when `nerf`
    names a snapshot."""
    import numpy as np

    from sienerf_torch.geom.mesh_io import save_obj

    obj = tmp / f"{name}.obj"
    save_obj(obj, tris.reshape(-1, 3), np.arange(tris.shape[0] * 3).reshape(-1, 3))
    geometry = [{"type": "Mesh", "path": obj.name, "scale": 2.0 * radius,
                 "center": [float(c) - 0.5 for c in center]}]
    if nerf is not None:
        geometry.append({"type": "Nerf", "path": str(nerf), "center": [0.0, 0.0, 0.0]})
    scene = tmp / f"{name}.geometry.json"
    scene.write_text(json.dumps({"geometry": geometry}))
    return scene


def hybrid_phase(fox, tr, dev, cuda_ms) -> dict:
    """The fork's hybrid frame: a code-built sphere in front of the fox
    (Session.load_file of a geometry scene JSON), a probe grid baked from
    the fox as the mesh's ambient light, the 720p hybrid sweep frame through
    K1 and K2 with the mesh's per-pixel t_stop, held to its plain versions,
    to the live hybrid frame and (48x27) to the CPU; the BVH tier (K3,
    held to the plain walk on a 720p frame's rays); the
    trained student's snapshot round trip; and the trainer's determinism."""
    import numpy as np
    import torch

    from sienerf_torch import metrics
    from sienerf_torch.engines import irradiance
    from sienerf_torch.engines.geometry import HYBRID_PHASES, GeometryObject
    from sienerf_torch.engines.nerf_sweep import axis_view
    from sienerf_torch.geom.bvh import brute_raytrace, bvh_raytrace
    from sienerf_torch.geom.mesh_io import icosphere
    from sienerf_torch.ops import bvh_kernel
    from sienerf_torch.ops.shade import shade_volume, shade_volume_plain
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel, sweep_composite_plain
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    out = {}
    tmp = Path(tempfile.mkdtemp())
    eye, target = np.asarray(HYBRID_EYE, np.float32), np.full(3, 0.5, np.float32)
    center = eye + HYBRID_SPHERE_AT * (target - eye)
    cam = look_at_matrix(eye, target)
    fox_obj = lambda: GeometryObject("nerf", np.zeros(3, np.float32), "fox", nerf=fox.engine,
                                     nerf_state=fox.state)  # noqa: E731

    # 1-3. the scene, the fox attached, the probe grid
    t = time.perf_counter()
    small = icosphere(5)
    scene = _write_scene(tmp, "sphere", small, center, HYBRID_RADIUS)
    hs = Session(device=dev).load_file(scene)
    geo = hs.engine
    geo.objects.append(fox_obj())
    log(f"[hybrid] scene {scene.name}: {small.shape[0]} triangles (brute tier: "
        f"{geo.brute_dev is not None}) at {np.round(center, 3).tolist()} radius {HYBRID_RADIUS}, "
        f"loaded in {time.perf_counter() - t:.2f} s")
    torch.cuda.synchronize()
    t = time.perf_counter()
    grid = irradiance.bake_probe_grid(fox.engine, fox.state, *PROBE_BOX, grid_size=3,
                                      env_width=32, env_height=16)
    torch.cuda.synchronize()
    out["probe_bake_s"] = time.perf_counter() - t
    coeffs = grid["coeffs"]
    check(bool(torch.isfinite(coeffs).all()) and float(coeffs[:, :, :, 0].min()) > 0,
          "probe grid: non-finite or non-positive DC coefficients")
    log(f"[hybrid] probe grid 3^3 x 32x16 rays baked from the fox in {out['probe_bake_s']:.2f} s, "
        f"coefficients {float(coeffs.min()):.3f}..{float(coeffs.max()):.3f}")
    geo.probe_grid, geo.shade_mode = grid, "grid"
    geo.brdf = dataclasses.replace(geo.brdf, basecolor=(0.75, 0.72, 0.68),
                                   ambientcolor=(1.0, 1.0, 1.0))

    # 4. the 720p hybrid sweep frame, the main path (Session.render): counts
    # from 0
    def frame(w=WIDTH, h=HEIGHT, g=geo, **kw):
        f = g.render_frame(w, h, cam, tuple(x * w / WIDTH for x in FOCAL), **kw)
        torch.cuda.synchronize()
        return f

    def session_frame():
        f = hs.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep")
        torch.cuda.synchronize()
        return f

    shade_volume.launches = sweep_composite_kernel.launches = 0
    t = time.perf_counter()
    first = session_frame()
    out["first_frame_s"] = time.perf_counter() - t  # includes the R=256 bake
    times = []
    for _ in range(HYBRID_TIMED):
        t = time.perf_counter()
        rgba = session_frame()
        times.append(1e3 * (time.perf_counter() - t))
    out["launches"] = {"shade": shade_volume.launches, "sweep": sweep_composite_kernel.launches}
    out["frame_ms"], out["frame_ms_runs"] = statistics.median(times), times
    n_frames = HYBRID_TIMED + 1
    for name, n in out["launches"].items():
        check(n == n_frames, f"hybrid path: kernel {name} launched {n} times for {n_frames} "
                             f"frames")
    mesh_hit = geo.render_mesh_rays(*geo._frame_rays(WIDTH, HEIGHT, cam, FOCAL, dev))[2]
    out["mesh_cover"] = float(mesh_hit.float().mean())
    check(rgba.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(rgba).all()),
          "hybrid frame: bad shape or non-finite values")
    check(0.10 <= out["mesh_cover"] <= 0.40, f"the sphere covers {out['mesh_cover']:.3f} of "
                                             "the pixels, not 10-40 %")
    stats = {"sync_phases": True}
    t = time.perf_counter()
    _, depth = frame(renderer="sweep", stats=stats)
    synced = 1e3 * (time.perf_counter() - t)
    cover = float(torch.isfinite(depth).float().mean())
    out["split_ms"] = {k: 1e3 * v for k, v in stats["phase_s"].items()}
    log(f"[hybrid] 1280x720 sweep frame: first {out['first_frame_s']:.2f} s (bake included), "
        f"median of {HYBRID_TIMED} {out['frame_ms']:.1f} ms (runs {[round(x, 1) for x in times]}); launches "
        f"{out['launches']}; mesh covers {100 * out['mesh_cover']:.1f} % of the pixels, "
        f"finite depth on {100 * cover:.1f} %; axis {stats['axis']} flip {stats['flip']}")
    log(f"[hybrid] where the time goes (one frame, the device synchronised after each part, "
        f"{synced:.1f} ms): " + ", ".join(f"{k} {out['split_ms'][k]:.1f} ms"
                                          for k in HYBRID_PHASES))
    # the kernels against their plain versions on this frame's inputs
    vol, (o_c, eb, ec, near, min_t), t_stop = stats["volume"], stats["intermediate"], \
        stats["t_stop"]
    fox_p = fox.state["params"]
    acts = dict(density_act=fox.engine.net.density_activation,
                rgb_act=fox.engine.net.rgb_activation)
    bake, meta = geo.objects[-1]._bake
    R, K = meta["resolution"], meta["n_cascades"]
    vol_plain = shade_volume_plain(bake["rows"], bake["scale"],
                                   torch.as_tensor(eye, device=dev), fox_p["rgb_mlp"],
                                   resolution=R, n_cascades=K, **acts)
    out["k1_err"] = compare("hybrid K1 volume", vol, vol_plain, **K1_TOL)
    del vol_plain
    stop_share = float(torch.isfinite(t_stop).float().mean())
    kw = dict(resolution=R, n_cascades=K, data_flip=stats["flip"])
    view = axis_view(vol, stats["axis"])
    want = sweep_composite_plain(view, o_c, eb, ec, near, min_t, t_stop, **kw)
    out["k2_err"] = max(compare(f"hybrid K2 {n} (mesh t_stop)", a, b.contiguous(), **K2_TOL)
                        for n, a, b in zip(("C", "opacity", "T", "depth_t"),
                                           stats["composite"], want))
    log(f"[hybrid] t_stop finite on {100 * stop_share:.1f} % of the {tuple(t_stop.shape)} "
        f"intermediate pixels")
    check(0.0 < stop_share < 1.0, "hybrid: the mesh stops no intermediate ray, or all")
    out["k2_ms"] = cuda_ms(lambda: sweep_composite_kernel(view, o_c, eb, ec, near, min_t,
                                                          t_stop, **kw), 10)
    out["k2_plain_ms"] = cuda_ms(lambda: sweep_composite_plain(view, o_c, eb, ec, near, min_t,
                                                               t_stop, **kw), 2)
    out["k2_bound"] = k2_bound_of(view, stats["flip"], o_c, eb, ec, near, min_t, R, K, t_stop)
    log(f"[hybrid] K2 with the mesh's t_stop: {out['k2_ms']:.4f} ms (plain "
        f"{out['k2_plain_ms']:.1f} ms), bound {out['k2_bound']['bound_ms']:.4f} ms "
        f"({out['k2_bound']['bound_by']}: {out['k2_bound']['bytes'] / 1e9:.4f} GB, "
        f"{out['k2_bound']['samples']} samples)")
    del want, view, vol, stats
    plain, _ = frame(renderer="sweep", impl="plain")
    agree = frame_agreement("hybrid sweep frame vs plain (K1 and K2 plain)", rgba, plain)
    check(agree >= HYBRID_MIN_AGREE, f"hybrid frame vs plain: {100 * agree:.3f} % agree")
    out["frame_vs_plain_agree"] = agree
    del plain

    # 5. the sweep hybrid against the live hybrid at 320x180
    sw, sh = HYBRID_SMALL
    t = time.perf_counter()
    live, _ = frame(sw, sh, renderer="live")
    live_s = time.perf_counter() - t
    swp, _ = frame(sw, sh, renderer="sweep")
    out["sweep_vs_live_psnr_db"] = float(metrics.psnr(swp[..., :3], live[..., :3]))
    out["sweep_vs_live_ssim"] = float(metrics.ssim(swp[..., :3], live[..., :3]))
    log(f"[hybrid] {sw}x{sh} live hybrid frame {live_s:.2f} s; sweep vs live PSNR "
        f"{out['sweep_vs_live_psnr_db']:.2f} dB, SSIM {out['sweep_vs_live_ssim']:.4f}")
    check(out["sweep_vs_live_psnr_db"] > QUALITY_MIN_DB, "hybrid sweep vs live PSNR too low")

    # 6. a small live hybrid frame against the same code on the CPU (the
    # card's probe grid, copied)
    cw, ch = HYBRID_CPU_SMALL
    card = frame(cw, ch, renderer="live")[0].cpu()
    cpu_fox = Session(device="cpu")
    cpu_fox.load_snapshot(SNAP)
    cs = Session(device="cpu").load_file(scene)
    cs.engine.objects.append(GeometryObject("nerf", np.zeros(3, np.float32), "fox",
                                            nerf=cpu_fox.engine, nerf_state=cpu_fox.state))
    cs.engine.probe_grid = {k: v.cpu() for k, v in grid.items()}
    cs.engine.shade_mode, cs.engine.brdf = "grid", geo.brdf
    t = time.perf_counter()
    on_cpu = cs.engine.render_frame(cw, ch, cam, tuple(x * cw / WIDTH for x in FOCAL))[0]
    err = (card - on_cpu).abs()
    ok = (err <= FRAME_TOL["atol"] + FRAME_TOL["rtol"] * on_cpu.abs()).all(dim=-1)
    out["cpu_agree"] = float(ok.float().mean())
    log(f"[hybrid] {cw}x{ch} live hybrid card vs CPU ({time.perf_counter() - t:.1f} s on the "
        f"CPU): {100 * out['cpu_agree']:.2f} % of pixels within rtol {FRAME_TOL['rtol']} atol "
        f"{FRAME_TOL['atol']}, max abs err {float(err.max()):.3g}")
    check(out["cpu_agree"] >= LIVE_MIN_AGREE, "live hybrid: card and CPU frames disagree")
    del cpu_fox, cs

    # 7. the BVH tier on the main path: the 81,920-triangle sphere at full
    # size through Session.render, K3 launched three times a frame (primary,
    # shadow and depth-stop rays); each launch's rays held to the plain walk
    # to the bit, timed, and bounded; then the two tiers on the
    # 20,480-triangle sphere, which both take
    big = icosphere(6)
    bscene = _write_scene(tmp, "sphere_big", big, center, HYBRID_RADIUS)
    bs = Session(device=dev).load_file(bscene)
    bgeo = bs.engine
    check(bgeo.brute_dev is None, "the 81,920-triangle mesh did not take the BVH tier")
    bgeo.objects.append(fox_obj())
    bgeo.probe_grid, bgeo.shade_mode, bgeo.brdf = grid, "grid", geo.brdf
    bgeo.objects[-1]._bake = geo.objects[-1]._bake

    def bvh_frame():
        f = bs.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep")
        torch.cuda.synchronize()
        return f

    bvh_frame()  # warm-up
    walk = bvh_kernel.bvh_walk_kernel
    walk.launches = shade_volume.launches = sweep_composite_kernel.launches = 0
    times = []
    for _ in range(BVH_TIMED):
        t = time.perf_counter()
        bframe = bvh_frame()
        times.append(1e3 * (time.perf_counter() - t))
    out["bvh_frame_ms"], out["bvh_frame_ms_runs"] = statistics.median(times), times
    out["bvh_launches"] = {"bvh_walk": walk.launches, "shade": shade_volume.launches,
                           "sweep": sweep_composite_kernel.launches}
    check(out["bvh_launches"] == {"bvh_walk": 3 * BVH_TIMED, "shade": BVH_TIMED,
                                  "sweep": BVH_TIMED},
          f"BVH tier frame: launches {out['bvh_launches']} for {BVH_TIMED} frames, not K3 "
          f"3, K1 1 and K2 1 a frame")
    check(bool(torch.isfinite(bframe).all()), "BVH tier frame: non-finite values")
    calls = []

    def captured(bvh, o, d, t_max=1e10, **kw):
        calls.append((bvh, o, d, t_max, kw))
        return walk(bvh, o, d, t_max, **kw)

    captured.launches = 0  # the wrapper counts its launches under its module's name
    bvh_kernel.bvh_walk_kernel = captured
    try:
        bvh_frame()
    finally:
        bvh_kernel.bvh_walk_kernel = walk
    kinds = ["shadow" if kw.get("any_hit") else "closest" for _, _, _, _, kw in calls]
    check(kinds == ["closest", "shadow", "closest"] and calls[0][2].shape[0] == WIDTH * HEIGHT,
          f"BVH tier frame: K3's launches were {kinds}, not primary, shadow, depth-stop")
    out["k3"] = k3_agreement(calls, walk, cuda_ms)
    out["k3"]["launches"] = out["bvh_launches"]["bvh_walk"]
    k3 = out["k3"]
    log(f"[hybrid] BVH tier ({big.shape[0]} triangles) {WIDTH}x{HEIGHT} sweep frame through "
        f"Session.render: median of {BVH_TIMED} {out['bvh_frame_ms']:.1f} ms, launches "
        f"{out['bvh_launches']}; K3 vs the plain walk on its rays: "
        + "; ".join(f"{n} {r['rays']} rays ({r['walked']} walked) equal {r['equal']}, "
                    f"K3 {r['ms']:.3f} ms, plain {r['plain_ms']:.1f} ms"
                    for n, r in k3["by_ray_set"].items())
        + f"; K3 {k3['ms']:.3f} ms a frame, plain {k3['plain_ms']:.1f} ms, bound "
          f"{k3['bound_ms']:.4f} ms ({k3['bound_by']})")
    check(all(r["equal"] for r in k3["by_ray_set"].values()),
          "K3 and the plain walk disagree on the BVH tier frame's rays")
    del bs, bgeo, bframe, calls
    sw, sh = HYBRID_SMALL
    o, d = geo._frame_rays(sw, sh, cam, tuple(x * sw / WIDTH for x in FOCAL), dev)
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    t = time.perf_counter()
    bt, bid, _, _ = bvh_raytrace(geo.bvh_dev, o, d)
    torch.cuda.synchronize()
    bvh_ms = 1e3 * (time.perf_counter() - t)
    rt, rid, _, _ = brute_raytrace(geo.brute_dev, o, d)
    same_hit = float(((bid >= 0) == (rid >= 0)).float().mean())
    both = (bid == rid) & (bid >= 0)
    t_err = float(((bt - rt).abs() / rt.abs())[both].max()) if bool(both.any()) else 0.0
    out["tiers"] = {"hit_agree": same_hit, "same_triangle": float(both.float().sum() /
                                                                  (rid >= 0).float().sum()),
                    "t_max_rel_err": t_err, "bvh_trace_ms": bvh_ms}
    log(f"[hybrid] BVH vs brute on the {small.shape[0]}-triangle sphere at {sw}x{sh}: hit "
        f"masks agree on {100 * same_hit:.3f} %, same triangle on "
        f"{100 * out['tiers']['same_triangle']:.3f} % of hits, t within {t_err:.2e} relative "
        f"(BVH trace {bvh_ms:.1f} ms)")
    check(same_hit >= HIT_MIN_AGREE and t_err <= 1e-5, "BVH and brute tiers disagree")

    # 8. the trained student, in memory and through its saved snapshot
    geo_mem = Session(device=dev).load_file(scene).engine
    geo_mem.objects.append(GeometryObject("nerf", np.zeros(3, np.float32), "student",
                                          nerf=tr["engine"], nerf_state=tr["state"]))
    rscene = _write_scene(tmp, "student", small, center, HYBRID_RADIUS, nerf=tr["snapshot"])
    t = time.perf_counter()
    loaded = Session(device=dev).load_file(rscene)
    load_s = time.perf_counter() - t
    n_nerf = sum(o.kind == "nerf" and o.nerf is not None for o in loaded.engine.objects)
    check(n_nerf == 1, "the student's snapshot did not load as the scene's NeRF object")
    a = frame(sw, sh, g=geo_mem, renderer="sweep")[0]
    b = frame(sw, sh, g=loaded.engine, renderer="sweep")[0]
    out["roundtrip_equal"] = bool(torch.equal(a, b))
    log(f"[hybrid] student snapshot loaded as a scene object in {load_s:.2f} s; its {sw}x{sh} "
        f"hybrid sweep frame is bit-equal to the in-memory student's: {out['roundtrip_equal']} "
        f"(max abs diff {float((a - b).abs().max()):.3g}, mean alpha {float(a[..., 3].mean()):.3f})")
    check(out["roundtrip_equal"], "the reloaded student renders another frame")
    del geo_mem, loaded

    # 9. the baked hybrid with two NeRF objects (the [baked] phase's part
    # that needs the trained student)
    t = time.perf_counter()
    out["baked"] = baked_hybrid(geo, scene, tr["snapshot"], dev, frame)
    out["baked"]["phase_s"] = time.perf_counter() - t
    log(f"[baked] hybrid part in {out['baked']['phase_s']:.1f} s")

    # 10. one seed, one result: two bundles, and two gradients, from one state
    out["determinism"] = determinism_check(tr["engine"], tr["state"], dev)
    check(all(v >= 0.0 for v in out["determinism"]["phase_ms_per_step"].values()),
          "determinism: no phase split")
    return out


def baked_phase(sess, live0, cam, cpu_sess, bake_s, dev) -> dict:
    """The baked gather renderer on the fox's R=256 bake (the sweep's,
    which carries every sidecar): the main path Session.render(renderer=
    "baked") at 1280x720 with the default knobs (G2 on 32-byte vertex rows)
    and with fine="brick" (G1 on 512-byte bricks), counts from 0; each
    kernel frame against the plain frame, bit for bit; G2 and G1 on the
    first round's own ids, bit-equal and timed; the 720p frame timed,
    counted and split; PSNR / SSIM against the 720p live frame; the knobs
    at 320x180; a trilinear R=128 bake; and 48x27 frames against the
    same code on the CPU."""
    import torch

    from sienerf_torch import metrics
    from sienerf_torch.engines.nerf_baked import (
        BAKED_PHASES,
        render_frame_baked,
        render_rays_baked,
    )
    from sienerf_torch.ops import baked as baked_ops
    from sienerf_torch.ops.gather import gather_rows, gather_small
    from sienerf_torch.tools import bench_gather

    out = {"bake_s": bake_s}
    grid, meta = sess._baked
    out["table_bytes"] = {k: int(v.numel() * v.element_size()) for k, v in grid.items()}
    log(f"[baked] the R={meta['resolution']} bake ({bake_s:.2f} s, every sidecar): "
        + ", ".join(f"{k} {b / 1e6:.2f} MB" for k, b in out["table_bytes"].items()))
    check("brows" in grid and "dist3d" in grid and "bits2b" in grid, "the bake lacks a sidecar")

    def frame(w=WIDTH, h=HEIGHT, **kw):
        img = sess.render(w, h, cam, tuple(f * w / WIDTH for f in FOCAL), renderer="baked",
                          **kw)
        torch.cuda.synchronize()
        return img

    # 1. the main path, counts from 0; the first gather of each row width is
    # kept (table, ids) for the kernel checks below
    seen = {}
    real = baked_ops.gather_table_rows

    def keep_first(table, ids, impl="kernel"):
        key = table.shape[1] * table.element_size()
        if key not in seen:
            seen[key] = (table, baked_ops._row_ids(ids, table.shape[0]).clone())
        return real(table, ids, impl)

    baked_ops.gather_table_rows = keep_first
    gather_rows.launches = gather_small.launches = 0
    main_stats, brick_stats = {}, {}
    try:
        t = time.perf_counter()
        img = frame(stats=main_stats)
        out["first_frame_s"] = time.perf_counter() - t
        img_brick = frame(fine="brick", stats=brick_stats)
    finally:
        baked_ops.gather_table_rows = real
    out["launches"] = {"gather_small": gather_small.launches, "gather_rows": gather_rows.launches}
    log(f"[baked] main path ({WIDTH}x{HEIGHT}, default knobs, then fine=brick): launches "
        f"{out['launches']}; default {main_stats['rounds']} rounds, {main_stats['ray_rounds']} "
        f"ray-rounds, {main_stats['evals']} evals, {main_stats['overflows']} overflows; "
        f"brick {brick_stats['rounds']} rounds, {brick_stats['evals']} evals, "
        f"{brick_stats['overflows']} overflows")
    for name, n in out["launches"].items():
        check(n >= 1, f"kernel {name} was never launched on the baked path")
    out["counts"] = {k: main_stats[k] for k in ("rounds", "ray_rounds", "evals", "overflows")}
    for name, got in (("default", img), ("fine=brick", img_brick)):
        check(got.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(got).all()),
              f"baked {name} frame: bad shape or non-finite values")
        check(float(got[..., 3].mean()) > 0.05 and float(got[..., :3].std()) > 1e-3,
              f"baked {name} frame: empty or constant")
    plain = frame(impl="plain")
    plain_brick = frame(fine="brick", impl="plain")
    out["kernel_equals_plain"] = bool(torch.equal(img, plain) and torch.equal(img_brick,
                                                                             plain_brick))
    log(f"[baked] kernel frames vs plain frames (G2 / G1 vs index_select): bit-equal "
        f"{out['kernel_equals_plain']} (max abs diff {float((img - plain).abs().max()):.3g} / "
        f"{float((img_brick - plain_brick).abs().max()):.3g})")
    check(out["kernel_equals_plain"], "the baked kernel frame differs from the plain frame")
    del plain, plain_brick

    # 2. the gathers on the first round's own ids
    out["gathers"] = {}
    for key, tag in ((32, "G2"), (512, "G1")):
        check(key in seen, f"no {key}-byte gather on the baked path")
        table, idx = seen[key]
        if key == 512:
            table = table.view(torch.int32)
        r = bench_gather.bench_table(tag, table, idx)
        out["gathers"][tag] = r
        log(f"[baked] {bench_gather.format_result(r)}")
        check(r["equal"], f"{tag} on the frame's ids differs from its plain version")
    del seen

    # 3. the 720p frame: time, counts, split, kernels a round, quality
    for _ in range(2):
        frame()
    times = []
    for _ in range(BAKED_TIMED):
        t = time.perf_counter()
        frame()
        times.append(1e3 * (time.perf_counter() - t))
    out["frame_ms"], out["frame_ms_runs"] = statistics.median(times), times
    split = {"sync_phases": True}
    t = time.perf_counter()
    frame(stats=split)
    synced = 1e3 * (time.perf_counter() - t)
    out["split_ms"] = {k: 1e3 * split["phase_s"][k] for k in BAKED_PHASES}
    out["host_wait_ms"] = 1e3 * main_stats["host_wait_s"]
    busy_ms, n_kernels, g2_ms = device_trace(frame, "gather_small")
    out["kernels_a_round"] = n_kernels / main_stats["rounds"]
    out["busy_ms"] = busy_ms if busy_ms > 0 else None
    out["g2_device_ms"] = g2_ms if busy_ms > 0 else None
    log(f"[baked] {WIDTH}x{HEIGHT} spp1: median of {BAKED_TIMED} {out['frame_ms']:.1f} ms (runs "
        f"{[round(x, 1) for x in times]}), first {1e3 * out['first_frame_s']:.1f} ms; "
        f"{main_stats['rounds']} rounds, host waited {out['host_wait_ms']:.1f} ms for the device")
    log(f"[baked] where the time goes (one frame, the device synchronised after each part, "
        f"{synced:.1f} ms): " + ", ".join(f"{k} {v:.1f} ms" for k, v in out["split_ms"].items()))
    if busy_ms > 0:
        log(f"[baked] trace: {n_kernels} device kernels and copies "
            f"({out['kernels_a_round']:.0f} a round), "
            f"busy {busy_ms:.1f} ms = {100 * busy_ms / out['frame_ms']:.1f} % of the frame; "
            f"G2 {out['g2_device_ms']:.3f} ms = {100 * out['g2_device_ms'] / out['frame_ms']:.2f} %"
            f" of the frame")
    else:
        log(f"[baked] trace: {n_kernels} device kernels and copies "
            f"({out['kernels_a_round']:.0f} a round); "
            "device busy share: not measured (the trace holds no device time)")
    out["psnr_vs_live_db"] = float(metrics.psnr(img[..., :3], live0[..., :3]))
    out["ssim_vs_live"] = float(metrics.ssim(img[..., :3], live0[..., :3]))
    log(f"[baked] {WIDTH}x{HEIGHT} baked vs live: PSNR {out['psnr_vs_live_db']:.2f} dB, SSIM "
        f"{out['ssim_vs_live']:.4f}; mean alpha baked {float(img[..., 3].mean()):.3f} live "
        f"{float(live0[..., 3].mean()):.3f}")
    check(out["psnr_vs_live_db"] >= BAKED_MIN_DB,
          f"baked vs live {out['psnr_vs_live_db']:.2f} dB < {BAKED_MIN_DB}")
    del img, img_brick

    # 4. the knobs at 320x180 against the default knobs
    sw, sh = BAKED_SMALL
    eng, params, bf = sess.engine, sess.render_params(), sess.state["occ"]["bitfield"]
    fs = tuple(f * sw / WIDTH for f in FOCAL)

    def small(g=grid, m=meta, **kw):
        rgba, _ = render_frame_baked(eng, params, bf, g, cam, fs, width=sw, height=sh,
                                     resolution=m["resolution"], mode=m["mode"],
                                     n_cascades=m["n_cascades"], **kw)
        return rgba

    base = small()
    out["knobs"] = {}
    for name, kw in (("cull=brick", dict(cull="brick")), ("cull=fine", dict(cull="fine")),
                     ("fine=brick", dict(fine="brick")), ("adv=scout", dict(adv="scout")),
                     ("adv=dist", dict(adv="dist"))):
        got = small(**kw)
        d_rgb = (got[..., :3] - base[..., :3]).abs()
        d_op = float((got[..., 3] - base[..., 3]).abs().max())
        db = float(metrics.psnr(got[..., :3], base[..., :3]))
        k = out["knobs"][name] = {"max_rgb": float(d_rgb.max()), "mean_rgb": float(d_rgb.mean()),
                                  "max_opacity": d_op, "psnr_db": db}
        log(f"[baked] {sw}x{sh} {name} vs default: max |rgb| {k['max_rgb']:.3g}, mean "
            f"{k['mean_rgb']:.3g}, max |opacity| {d_op:.3g}, PSNR {db:.2f} dB")
        if name.startswith("adv"):
            check(db > QUALITY_MIN_DB, f"baked {name}: {db:.2f} dB against the default")
        else:
            max_rgb = CULL_FINE_MAX_RGB if name == "cull=fine" else CULL_TOL["rgb"]
            check(k["max_rgb"] <= max_rgb and d_op <= CULL_TOL["opacity"]
                  and k["mean_rgb"] < CULL_TOL["mean_rgb"],
                  f"baked {name} leaves the cull tolerance against the default")
    t = time.perf_counter()
    tgrid, tmeta = eng.bake_features(params, sess.state["occ"], resolution=TRILINEAR_RES,
                                     mode="trilinear")
    torch.cuda.synchronize()
    out["trilinear_bake_s"] = time.perf_counter() - t
    nocull = small(tgrid, tmeta, candidates=32, evals=32)
    culled = small(tgrid, tmeta, candidates=32, evals=12)
    out["trilinear_psnr_db"] = float(metrics.psnr(culled[..., :3], nocull[..., :3]))
    log(f"[baked] trilinear R={TRILINEAR_RES} bake {out['trilinear_bake_s']:.2f} s (cell rows "
        f"{tgrid['rows'].numel() * 2 / 1e9:.2f} GB); {sw}x{sh} culled (12 of 32 evals) vs no "
        f"cull: PSNR {out['trilinear_psnr_db']:.2f} dB")
    check(out["trilinear_psnr_db"] > TRILINEAR_MIN_DB, "trilinear cull vs no cull")
    del tgrid, nocull, culled

    # 5. the card against the CPU at BAKED_CPU_SMALL, on the card's bake:
    # the default knobs and the two batched advances
    cw, ch = BAKED_CPU_SMALL
    cpu_sess._baked = ({k: v.cpu() for k, v in grid.items()}, dict(meta))
    out["cpu_agree"] = {}
    for name, kw in (("default", {}), ("adv=scout", dict(adv="scout")),
                     ("adv=dist", dict(adv="dist"))):
        card = frame(cw, ch, **kw).cpu()
        t = time.perf_counter()
        on_cpu = cpu_sess.render(cw, ch, cam, tuple(f * cw / WIDTH for f in FOCAL),
                                 renderer="baked", **kw)
        cpu_s = time.perf_counter() - t
        err = (card - on_cpu).abs()
        ok = (err <= FRAME_TOL["atol"] + FRAME_TOL["rtol"] * on_cpu.abs()).all(dim=-1)
        out["cpu_agree"][name] = agree = float(ok.float().mean())
        log(f"[baked] {cw}x{ch} {name} card vs CPU ({cpu_s:.1f} s on the CPU): "
            f"{100 * agree:.2f} % of pixels within rtol {FRAME_TOL['rtol']} atol "
            f"{FRAME_TOL['atol']}, max abs err {float(err.max()):.3g}, PSNR "
            f"{metrics.psnr(card[..., :3], on_cpu[..., :3]):.2f} dB")
        check(agree >= LIVE_MIN_AGREE, f"baked {name} frame: card and CPU disagree")
    cpu_sess._baked = None
    return out


def baked_hybrid(ref_geo, geo_scene: Path, snapshot: Path, dev, frame) -> dict:
    """The baked hybrid: the student's snapshot loaded twice, at two
    centres behind the sphere; the 720p frame through render_rays_baked
    (G2) timed and split, kernel against plain, and the 320x180 baked
    hybrid against the live hybrid."""
    import torch

    from sienerf_torch import metrics
    from sienerf_torch.ops.gather import gather_rows, gather_small
    from sienerf_torch.session import Session

    scene = json.loads(geo_scene.read_text())
    scene["geometry"] += [{"type": "Nerf", "path": str(snapshot), "center": c}
                          for c in HYBRID_NERF_CENTERS]
    path = geo_scene.with_name("two_nerfs.geometry.json")
    path.write_text(json.dumps(scene))
    out = {}
    t = time.perf_counter()
    geo = Session(device=dev).load_file(path).engine
    geo.probe_grid, geo.shade_mode, geo.brdf = ref_geo.probe_grid, "grid", ref_geo.brdf
    n_nerf = sum(o.kind == "nerf" and o.nerf is not None for o in geo.objects)
    check(n_nerf == 2, f"the two-NeRF scene loaded {n_nerf} NeRF objects")
    geo._ensure_nerf_bakes([o for o in geo.objects if o.kind == "nerf"])
    torch.cuda.synchronize()
    out["load_and_bake_s"] = time.perf_counter() - t
    gather_rows.launches = gather_small.launches = 0
    kw = dict(g=geo, tile=HYBRID_BAKED_TILE)
    first, _ = frame(renderer="baked", **kw)
    out["launches"] = {"gather_small": gather_small.launches, "gather_rows": gather_rows.launches}
    check(out["launches"]["gather_small"] >= 1, "the baked hybrid launched no G2")
    times = []
    for _ in range(HYBRID_BAKED_TIMED):
        t = time.perf_counter()
        frame(renderer="baked", **kw)
        times.append(1e3 * (time.perf_counter() - t))
    out["frame_ms"], out["frame_ms_runs"] = statistics.median(times), times
    split = {"sync_phases": True}
    frame(renderer="baked", stats=split, **kw)
    out["split_ms"] = {k: 1e3 * v for k, v in split["phase_s"].items()}
    plain, _ = frame(renderer="baked", impl="plain", **kw)
    out["kernel_equals_plain"] = bool(torch.equal(first, plain))
    sw, sh = HYBRID_SMALL
    sweep_two, _ = frame(sw, sh, renderer="sweep", **kw)  # two NeRF objects: baked
    out["sweep_routes_baked"] = bool(torch.equal(sweep_two, frame(sw, sh, renderer="baked",
                                                                  **kw)[0]))
    log(f"[baked] hybrid, two student NeRFs behind the sphere: scene loaded and baked in "
        f"{out['load_and_bake_s']:.1f} s; {WIDTH}x{HEIGHT} median of {HYBRID_BAKED_TIMED} "
        f"{out['frame_ms']:.1f} ms "
        f"(runs "
        f"{[round(x, 1) for x in times]}), launches {out['launches']}; split "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in out["split_ms"].items())
        + f" (no depth trace: the mesh depth caps each ray); kernel vs plain bit-equal "
        f"{out['kernel_equals_plain']}; renderer=sweep takes the baked path: "
        f"{out['sweep_routes_baked']}")
    check(out["kernel_equals_plain"], "baked hybrid: kernel frame differs from plain")
    check(out["sweep_routes_baked"], "the two-NeRF sweep frame is not the baked frame")
    check(bool(torch.isfinite(first).all()), "baked hybrid: non-finite values")
    del first, plain, sweep_two
    sw, sh = HYBRID_BAKED_SMALL
    t = time.perf_counter()
    live, _ = frame(sw, sh, g=geo, renderer="live")
    live_s = time.perf_counter() - t
    baked, _ = frame(sw, sh, renderer="baked", **kw)
    out["psnr_vs_live_db"] = float(metrics.psnr(baked[..., :3], live[..., :3]))
    out["ssim_vs_live"] = float(metrics.ssim(baked[..., :3], live[..., :3]))
    log(f"[baked] hybrid {sw}x{sh}: live {live_s:.2f} s; baked vs live PSNR "
        f"{out['psnr_vs_live_db']:.2f} dB, SSIM {out['ssim_vs_live']:.4f}")
    check(out["psnr_vs_live_db"] > QUALITY_MIN_DB, "baked hybrid vs live PSNR too low")
    return out


def determinism_check(eng, state, dev, steps: int = DETERMINISM_STEPS, tag: str = "") -> dict:
    """Two training bundles of `steps` steps from one state and one seed
    must give the same loss and the same params and occupancy bit for bit,
    and two gradient evaluations of one batch the same loss and gradients
    in every leaf.  The first bundle is phase-synchronised: its split is
    returned ("phase_ms_per_step")."""
    import torch

    from sienerf_torch.ops.optim import tree_leaves

    t = time.perf_counter()
    runs = []
    mean = eng._mean_samples  # a bundle updates it; both start from it
    short = dataclasses.replace(eng, grid_interval=steps)
    split = None
    for i in range(2):
        short._mean_samples = mean
        stats = {"sync_phases": i == 0}
        st, loss, _ = short.train_bundle(state, torch.Generator(device=dev).manual_seed(7),
                                         stats)
        if i == 0:
            split = phase_split(stats, steps)
        runs.append((float(loss), tree_leaves(st["params"]), st["occ"]["density"]))
    same_bundle = (runs[0][0] == runs[1][0]
                   and all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
                   and torch.equal(runs[0][2], runs[1][2]))
    eng._mean_samples = mean
    n_rays, k, iters = eng._phase_geometry()
    draws = eng.draw_step(torch.Generator(device=dev).manual_seed(8), n_rays, int(state["step"]))
    g = [eng.loss_and_grads(state, draws, k, iters)[:2] for _ in range(2)]
    same_grads = bool(torch.equal(g[0][0], g[1][0]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(g[0][1]), tree_leaves(g[1][1]))))
    out = {"bundle_loss": [r[0] for r in runs], "bundles_equal": bool(same_bundle),
           "grads_equal": same_grads, "seconds": time.perf_counter() - t, "steps": steps,
           "phase_ms_per_step": split}
    log(f"[determinism{tag}] two bundles of {steps} steps from one state and seed: losses "
        f"{out['bundle_loss']}, params and occupancy bit-equal: {out['bundles_equal']}; two "
        f"gradients of one batch ({n_rays} rays x k {k}) bit-equal: {same_grads} "
        f"({out['seconds']:.1f} s)")
    check(out["bundles_equal"] and same_grads, "training is not deterministic on the card")
    return out


# -- the image, SDF and volume modes and mesh export (Slice F) ----------------


def device_trace(fn, name_part: str = "") -> tuple:
    """fn() under a CUDA profiler trace -> (device busy ms, device events,
    ms of the events whose name holds `name_part`), summed from the trace's
    raw events: key_averages builds a Python object a record, which over a
    720p live frame's trace took most of a minute."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    busy = part = n = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy += e.duration_ns()
            n += 1
            if name_part and name_part in e.name():
                part += e.duration_ns()
    return busy / 1e6, n, part / 1e6


def k2_bound_of(view, flip: bool, o_c, eb, ec, near, min_t, R: int, K: int,
                t_stop=None) -> dict:
    """K2's bound from this run's inputs, counted with the plain composite's
    stats: the distinct texels (4 bf16 channels) that live samples read,
    the schedule, the gnomonic coordinates, t_stop when given, and the six
    f32 output maps at the HBM rate; K2_FLOPS_PER_SAMPLE a live sample at
    the f32 peak -> the larger of the two."""
    from sienerf_torch.ops.sweep import sweep_composite

    stats: dict = {}
    sweep_composite(view.flip(1) if flip else view, o_c, eb, ec, near, min_t, t_stop,
                    resolution=R, n_cascades=K, stats=stats)
    samples, texels = int(stats["samples"]), int(stats["texels"])
    hi, wi = eb.shape[0], ec.shape[0]
    nbytes = (texels * 4 * 2 + K * R * 5 * 4 + (hi + wi) * 4 + hi * wi * 6 * 4
              + (hi * wi * 4 if t_stop is not None else 0))
    tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * samples * K2_FLOPS_PER_SAMPLE / F32_FLOPS
    return {"bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "bytes": nbytes, "samples": samples, "texels": texels}


def k3_agreement(calls, walk, cuda_ms) -> dict:
    """K3's launches of one frame, replayed: each against the plain walk
    (geom/bvh.py::bvh_raytrace_plain) on the same rays (ids, u, v and t's
    bits equal; any hit equal to the plain closest hit's id >= 0), timed,
    and bounded as k3_roofline bounds them: the box and triangle tests of
    the benchmark's own walk (perfbench/bvh_work.py) on every 64th walked
    ray at the f32 peak, or the rays in, the results out and the BVH once
    at the HBM rate -> {"by_ray_set", "ms", "plain_ms", "bound_ms",
    "bound_by"}."""
    import torch

    from perfbench import bvh_work
    from sienerf_torch.geom.bvh import bvh_raytrace_plain

    by, flops, nbytes = {}, 0, 0
    for name, (bvh, o, d, t_max, kw) in zip(("primary", "shadow", "depth_stop"), calls):
        n, mask, any_hit = d.shape[0], kw.get("mask"), bool(kw.get("any_hit"))
        got = walk(bvh, o, d, t_max, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = bvh_raytrace_plain(bvh, o, d, t_max, mask=mask)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t)
        if any_hit:
            equal = bool(torch.equal(got, want[1] >= 0))
        else:
            bits = [x.view(torch.int32) for x in (got[0], want[0], got[2], want[2], got[3],
                                                   want[3])]
            equal = bool(torch.equal(got[1], want[1])) and all(
                bool(torch.equal(a, b)) for a, b in zip(bits[::2], bits[1::2]))
        ms = cuda_ms(lambda: walk(bvh, o, d, t_max, **kw), 10)
        walked = torch.arange(n, device=d.device) if mask is None else torch.nonzero(mask)[:, 0]
        sample = walked[::bvh_work.STRIDE]
        shared = o.stride(0) == 0
        n_box, n_tri, _, _ = bvh_work.walk(bvh, o[0] if shared else o[sample], d[sample],
                                           any_hit=any_hit)
        flops += bvh_work.STRIDE * (n_box * bvh_work.BOX_FLOPS + n_tri * bvh_work.TRI_FLOPS)
        nbytes += (12 if shared else 12 * walked.numel()) + 12 * walked.numel() \
            + (n if mask is not None else 0) + (n if any_hit else 20 * n) \
            + bvh["skip"].shape[0] * 48 + bvh["tri_a"].shape[0] * 36
        by[name] = {"rays": n, "walked": int(walked.numel()), "equal": equal, "ms": ms,
                    "plain_ms": plain_ms}
    tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * flops / F32_FLOPS
    return {"by_ray_set": by, "ms": sum(r["ms"] for r in by.values()),
            "plain_ms": sum(r["plain_ms"] for r in by.values()), "bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations", "bytes": nbytes,
            "flops": flops}


def sync_ms(fn) -> float:
    """Host ms of fn() with the device synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def bundles_ms(fn, n: int, steps: int):
    """n bundles of fn() (`steps` steps each, returning the bundle's loss),
    the device synchronised at bundle ends -> (ms a step of each bundle,
    the losses)."""
    ms, losses = [], []
    for _ in range(n):
        box = []
        ms.append(sync_ms(lambda: box.append(fn())) / steps)
        losses.append(float(box[0]))
    return ms, losses


def phase_split(stats: dict, per: int = 1) -> dict:
    """stats["phase_s"] as ms, divided by `per` (the steps of a bundle)."""
    return {k: round(1e3 * v / per, 3) for k, v in stats["phase_s"].items()}


def host_rss_gib() -> float:
    """The process's largest resident set so far, GiB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def kernel_counts() -> dict:
    from sienerf_torch.ops.gather import gather_rows, gather_small
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel

    return {"shade": shade_volume.launches, "sweep": sweep_composite_kernel.launches,
            "gather_rows": gather_rows.launches, "gather_small": gather_small.launches}


def zero_kernel_counts() -> None:
    from sienerf_torch.ops.gather import gather_rows, gather_small
    from sienerf_torch.ops.shade import shade_volume
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel

    shade_volume.launches = sweep_composite_kernel.launches = 0
    gather_rows.launches = gather_small.launches = 0


def card_vs_cpu_step(name: str, call, params_cpu: dict, dev,
                     loss_rtol: float = MODE_STEP_LOSS_RTOL, mlp_by_name: bool = False,
                     before_checks=None) -> dict:
    """One injected training step's loss and gradients on the card against
    the same step on the CPU: `call(params, device) -> (loss, grads)` runs
    the mode's loss_and_grads on inputs it moves to `device`.  The loss at
    the CPU tests' rtol 1e-4 and, with the card's bf16 roundings of every
    MLP input put into the CPU step, at STEP_FLIP_RTOL; the gradients at
    the tolerances of tests/test_torch_hashgrad.py.  `loss_rtol` sets the
    raw loss's tolerance; with `mlp_by_name` the MLP tolerance applies to
    the leaves under keys ending in "mlp" (a NeRF's learners have 2-D
    leaves too), else to every 2-D leaf.  `before_checks()`, when given,
    runs (to log more) after the numbers are printed and before the checks."""
    import torch

    from sienerf_torch.ops.mlp import tap_roundings
    from sienerf_torch.ops.optim import tree_leaves, tree_map

    cpu = torch.device("cpu")
    with tap_roundings() as cpu_tap:
        loss, grads = call(params_cpu, cpu)
    with tap_roundings() as tap:
        gloss, ggrads = call(tree_map(lambda t: t.to(dev), params_cpu), dev)
    torch.cuda.synchronize()
    with tap_roundings(replace=[v.detach().cpu() for v in tap.seen]):
        loss_inj = call(params_cpu, cpu)[0]
    flips = sum(int((a.cpu() != b).sum()) for a, b, k in zip(tap.seen, cpu_tap.seen, tap.kinds)
                if k == "rounded")
    raw = abs(float(gloss) - float(loss)) / abs(float(loss))
    inj = abs(float(gloss) - float(loss_inj)) / abs(float(loss))
    worst, by_leaf, mlp_ok = 0.0, {}, {}
    named = [(k, i) for k, v in grads.items() for i in range(len(v) if isinstance(v, list)
                                                             else 1)]
    for leaf, (a, b) in enumerate(zip(tree_leaves(ggrads), tree_leaves(grads))):
        a = a.cpu()
        share = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
        worst = max(worst, share)
        by_leaf["%s[%d]" % named[leaf]] = share
        is_mlp = named[leaf][0].endswith("mlp") if mlp_by_name else a.dim() == 2
        if is_mlp:  # an MLP matrix
            mlp_ok[leaf] = bool(torch.allclose(a, b, **STEP_MLP_TOL))
    log(f"[{name}] card step vs CPU: loss {float(gloss):.7g} vs {float(loss):.7g} (rel "
        f"{raw:.3g}; {inj:.3g} with the card's roundings put in, {flips} bf16 roundings "
        f"differ), gradients within {100 * worst:.3f} % of their largest entry: "
        + ", ".join(f"{k} {100 * v:.3f} %" for k, v in by_leaf.items()))
    if before_checks is not None:
        before_checks()
    for leaf, (key, share) in enumerate(by_leaf.items()):
        check(share <= STEP_MAX_SHARE, f"[{name}] gradient leaf {leaf} ({key}): {share:.3g} "
                                       f"of max")
        check(mlp_ok.get(leaf, True), f"[{name}] MLP gradient {leaf}")
    check(raw <= loss_rtol, f"[{name}] card step loss: rel {raw:.3g}")
    check(inj <= STEP_FLIP_RTOL, f"[{name}] card loss vs the CPU's with the card's roundings: "
                                 f"rel {inj:.3g}")
    return {"loss_card": float(gloss), "loss_cpu": float(loss), "loss_rel": raw,
            "loss_rel_flips_in": inj, "flipped_roundings": flips, "grad_worst_share": worst,
            "grad_share_by_leaf": by_leaf}


def procedural_image(n: int, seed: int = 0):
    """An (n, n, 4) f32 RGBA image with detail at every scale: zone plates
    whose frequency reaches the Nyquist limit at the border (red, green), a
    ramp (blue), a band of text lines of glyph-like 5x7 blocks of ink, and
    an alpha that falls off outside a disc."""
    import numpy as np

    rng = np.random.default_rng(seed)
    c = np.arange(n, dtype=np.float32) - n / 2
    y, x = np.meshgrid(c, c, indexing="ij")
    r2 = x * x + y * y
    img = np.empty((n, n, 4), np.float32)
    img[..., 0] = 0.5 + 0.5 * np.cos(np.float32(np.pi / n) * r2)
    img[..., 1] = 0.5 + 0.5 * np.cos(np.float32(np.pi / (2 * n)) * r2 + np.float32(1.0))
    img[..., 2] = (x + n / 2) / n
    img[..., 3] = np.clip(1.5 - np.sqrt(r2) / (0.6 * n), 0.0, 1.0)
    px = max(n // 512, 1)  # pixels a glyph cell
    rows, cols = n // (4 * 9 * px), n // (6 * px)
    ink = np.zeros((rows, 9, cols, 6), bool)
    ink[:, 1:8, :, :5] = (rng.random((rows, cols, 7, 5)) < 0.45).transpose(0, 2, 1, 3)
    ink = np.repeat(np.repeat(ink.reshape(rows * 9, cols * 6), px, 0), px, 1)
    img[n // 8:n // 8 + ink.shape[0], :ink.shape[1], :3][ink] = 0.05
    return img


def image_phase(dev, tmp: Path) -> dict:
    """configs/image/base.json at full width (16 levels x 2 features, 2^24
    rows, 2^18 samples a step) on a procedural IMAGE_RES^2 RGBA image that
    the port's codec writes as a half-float EXR and Session.load_file
    reads."""
    import numpy as np
    import torch

    from sienerf_torch.engines.image import ImageEngine
    from sienerf_torch.io.exr import write_exr
    from sienerf_torch.session import Session

    out = {}
    t = time.perf_counter()
    img = procedural_image(IMAGE_RES)
    write_exr(tmp / "procedural.exr", img)
    out["write_exr_s"] = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t = time.perf_counter()
    sess = Session(device=dev)
    sess.load_file(tmp / "procedural.exr")
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t
    eng, g = sess.engine, sess.engine.net.grid
    table = sess.state["params"]["grid"]
    log(f"[image] {IMAGE_RES}x{IMAGE_RES} RGBA half EXR "
        f"({(tmp / 'procedural.exr').stat().st_size / 2 ** 20:.1f} MiB) made and written in "
        f"{out['write_exr_s']:.2f} s, loaded in {out['load_s']:.2f} s; table "
        f"{tuple(table.shape)} f32, {table.numel() * 4 / 1e9:.2f} GB; batch {eng.batch_size}")
    check(g.n_levels == 16 and g.log2_hashmap_size == 24 and eng.batch_size == 1 << 18,
          "image mode is not at the configuration's full width")
    check(torch.equal(eng.image.cpu(), torch.from_numpy(
        img.astype(np.float16).astype(np.float32))), "the EXR did not load as written")
    del img, table
    p, o = sess.state["params"], sess.state["opt"]
    psnr0 = eng.psnr(p, o)
    ms, losses = bundles_ms(lambda: sess.train(16), IMAGE_BUNDLES, 16)
    stats = {"sync_phases": True}
    eng.train_step(p, o, sess._generator, stats=stats)
    out["split_ms"] = phase_split(stats)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["render_ms"] = sync_ms(lambda: eng.render(p, o, IMAGE_RES, IMAGE_RES))
    psnr1 = eng.psnr(p, o)
    out.update(ms_per_step=statistics.median(ms), ms_runs=[round(x, 2) for x in ms],
               loss_first_last=(losses[0], losses[-1]), psnr0_db=psnr0, psnr_db=psnr1,
               launches=kernel_counts())
    log(f"[image] {IMAGE_BUNDLES} bundles of 16 steps: {out['ms_per_step']:.2f} ms a step "
        f"(median; bundles {out['ms_runs']}), loss {losses[0]:.5f} -> {losses[-1]:.5f}; one "
        f"synced step: {out['split_ms']} ms; peak memory {out['peak_mem_gb']:.2f} GB")
    log(f"[image] the whole {IMAGE_RES}x{IMAGE_RES} render {out['render_ms']:.1f} ms; PSNR "
        f"against its own training image {psnr0:.2f} -> {psnr1:.2f} dB after "
        f"{IMAGE_BUNDLES * 16 + 1} steps; kernel launches {out['launches']}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0], "image: the loss did not fall")
    check(psnr1 >= psnr0 + IMAGE_MIN_GAIN_DB,
          f"image: PSNR {psnr0:.2f} -> {psnr1:.2f} dB, under +{IMAGE_MIN_GAIN_DB} dB")
    del sess, eng, p, o
    torch.cuda.empty_cache()
    # one injected step on the card against the CPU: the grid at 2^16 rows
    # (16 x 2 still) on a 256^2 image, the same coordinates
    cfg = json.loads((ROOT / "configs" / "image" / "base.json").read_text())
    cfg["encoding"]["log2_hashmap_size"] = 16
    crop = procedural_image(256, seed=1)
    engs = [ImageEngine.create(cfg, crop, batch_size=MODE_CHECK_BATCH, device=d)
            for d in ("cpu", dev)]
    params, _ = engs[0].init(3)
    coords = torch.rand((MODE_CHECK_BATCH, 2), generator=torch.Generator().manual_seed(4))
    out["card_vs_cpu"] = card_vs_cpu_step(
        "image", lambda prm, d: engs[d != torch.device("cpu")].loss_and_grads(
            prm, coords.to(d)), params, dev)
    return out


def on_cpu(eng, **fields):
    """A copy of a mode's engine whose tensors are on the CPU."""
    import torch

    return dataclasses.replace(eng, device=torch.device("cpu"), **{
        k: (v.cpu() if hasattr(v, "cpu") else {n: t.cpu() for n, t in v.items()})
        for k, v in fields.items()})


def sdf_phase(dev, tmp: Path):
    """configs/sdf/base.json at full width (16 x 2, 2^19 rows, 2^16
    samples, host ground truth) on an 81,920-triangle sphere beside a box,
    written as OBJ and loaded by Session.load_file -> (numbers, session)."""
    import numpy as np
    import torch

    from sienerf_torch.geom.mesh_io import box_mesh, icosphere, save_obj
    from sienerf_torch.ops.optim import tree_map
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    out = {}
    tri = np.concatenate([icosphere(SDF_SPHERE_SUBDIV, 0.3) + np.float32([0.35, 0.5, 0.5]),
                          box_mesh((0.72, 0.3, 0.3), (0.95, 0.75, 0.65))])
    save_obj(tmp / "scene.obj", tri.reshape(-1, 3), np.arange(3 * len(tri)).reshape(-1, 3))
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t = time.perf_counter()
    sess = Session(device=dev)
    sess.load_file(tmp / "scene.obj")
    out["load_s"] = time.perf_counter() - t
    eng, g = sess.engine, sess.engine.net.grid
    log(f"[sdf] {len(tri)} triangles as OBJ, loaded (native BVH, {eng.bvh_host.n_nodes} nodes) "
        f"in {out['load_s']:.2f} s; grid {g.n_levels}x{g.n_features_per_level}, "
        f"2^{g.log2_hashmap_size} rows, batch {eng.batch_size}")
    check(len(eng.bvh_host.triangles) == len(tri) and g.n_levels == 16
          and g.log2_hashmap_size == 19 and eng.batch_size == 1 << 16,
          "SDF mode is not at the configuration's full width")
    t = time.perf_counter()
    iou0 = sess.calculate_iou(SDF_IOU_RES)
    out["iou_s"] = time.perf_counter() - t
    ms, losses = bundles_ms(lambda: sess.train(16), SDF_BUNDLES, 16)
    stats = {"sync_phases": True}
    sess.state, _ = eng.train_bundle(sess.state, sess._generator, stats=stats)
    sess.training_step += 16
    out["split_ms"] = phase_split(stats, 16)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    iou1 = sess.calculate_iou(SDF_IOU_RES)
    out.update(ms_per_step=statistics.median(ms), ms_runs=[round(x, 2) for x in ms],
               loss_first_last=(losses[0], losses[-1]), iou_untrained=iou0, iou=iou1)
    gt_share = out["split_ms"]["ground_truth"] / sum(out["split_ms"].values())
    log(f"[sdf] {SDF_BUNDLES} bundles of 16 steps: {out['ms_per_step']:.2f} ms a step "
        f"(median; bundles {out['ms_runs']}), loss {losses[0]:.5f} -> {losses[-1]:.5f}; a "
        f"synced bundle a step: {out['split_ms']} ms, host ground truth "
        f"{100 * gt_share:.1f} % ({eng_threads()} threads); peak memory "
        f"{out['peak_mem_gb']:.2f} GB")
    log(f"[sdf] IoU at {SDF_IOU_RES}^3 ({out['iou_s']:.2f} s): untrained {iou0:.4f}, after "
        f"{sess.training_step} steps {iou1:.4f}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0], "SDF: the loss did not fall")
    check(iou1 >= iou0 + SDF_MIN_IOU_GAIN, f"SDF: IoU {iou0:.4f} -> {iou1:.4f}")
    # 1280x720 frames with shadows: the first, a timed one, a synced one
    cam = look_at_matrix(SDF_EYE, [0.5, 0.5, 0.5])
    out["first_frame_ms"] = sync_ms(lambda: sess.render(WIDTH, HEIGHT, cam))
    fstats = {}
    box = []
    out["frame_ms"] = sync_ms(lambda: box.append(sess.render(WIDTH, HEIGHT, cam, stats=fstats)))
    frame = box[0]
    sstats = {"sync_phases": True}
    sess.render(WIDTH, HEIGHT, cam, stats=sstats)
    out["frame_split_ms"] = phase_split(sstats)
    out["trace_iters"] = fstats["trace_iters"]
    hit = float((frame[..., :3] != 1.0).any(dim=-1).float().mean())
    log(f"[sdf] {WIDTH}x{HEIGHT} frame, shadows on: first {out['first_frame_ms']:.1f} ms, then "
        f"{out['frame_ms']:.1f} ms ({out['trace_iters']} sphere-trace iterations, primary and "
        f"shadow); synced: {out['frame_split_ms']} ms; {100 * hit:.1f} % of pixels hit")
    check(frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
          and 0.05 < hit < 0.95, "SDF frame: empty, full or not finite")
    # the card against the CPU: a 160x90 frame and one injected step
    params = sess.render_params()
    ceng = on_cpu(eng, bvh_dev=eng.bvh_dev, tri_normals=eng.tri_normals, tri_cdf=eng.tri_cdf)
    pc = tree_map(lambda x: x.cpu(), params)
    sw, sh = SDF_SMALL
    a, ad = eng.render_frame(params, sw, sh, cam)
    t = time.perf_counter()
    b, bd = ceng.render_frame(pc, sw, sh, cam)
    hits_differ = float((torch.isfinite(ad.cpu()) != torch.isfinite(bd)).float().mean())
    close = torch.isclose(a.cpu(), b, **STEP_MLP_TOL).all(dim=-1).float().mean()
    out["cpu_frame"] = {"hits_differ": hits_differ, "close": float(close),
                        "cpu_s": time.perf_counter() - t}
    log(f"[sdf] {sw}x{sh} card vs CPU ({out['cpu_frame']['cpu_s']:.1f} s on the CPU): hit masks "
        f"differ on {100 * hits_differ:.2f} % of pixels, colours within rtol 1e-2 / atol 1e-3 "
        f"on {100 * float(close):.2f} %")
    check(hits_differ <= 0.01 and float(close) >= 0.97, "SDF: the card frame is not the CPU's")
    pos, tgt = eng.draw_bundle(torch.Generator(device=dev).manual_seed(6), 1)
    pos, tgt = pos[0, :MODE_CHECK_BATCH].cpu(), tgt[0, :MODE_CHECK_BATCH].cpu()
    engs = [ceng, eng]
    out["card_vs_cpu"] = card_vs_cpu_step(
        "sdf", lambda prm, d: engs[d != torch.device("cpu")].loss_and_grads(
            prm, pos.to(d), tgt.to(d)),
        tree_map(lambda x: x.cpu(), sess.state["params"]), dev)
    out["launches"] = kernel_counts()
    return out, sess


def eng_threads() -> int:
    return max(1, (os.cpu_count() or 4) - 1)


def volume_phase(dev, tmp: Path) -> dict:
    """configs/volume/base.json at full width (8 x 4, 2^19 rows, 2^16
    samples) on a VOLUME_RES^3 synthetic shell written as .nvdb by the port
    and loaded by Session.load_file."""
    import numpy as np
    import torch

    from sienerf_torch.io.nanovdb import synthetic_fog_volume, write_nanovdb
    from sienerf_torch.ops.optim import tree_map
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    out = {}
    t = time.perf_counter()
    vol = synthetic_fog_volume(VOLUME_RES, "shell")
    write_nanovdb(tmp / "shell.nvdb", vol.density)
    out["write_s"] = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t = time.perf_counter()
    sess = Session(device=dev)
    sess.load_file(tmp / "shell.nvdb")
    out["load_s"] = time.perf_counter() - t
    eng, g = sess.engine, sess.engine.net.grid
    log(f"[volume] {VOLUME_RES}^3 shell as .nvdb ({(tmp / 'shell.nvdb').stat().st_size / 2 ** 20:.1f}"
        f" MiB) made and written in {out['write_s']:.2f} s, loaded in {out['load_s']:.2f} s; "
        f"majorant {eng.majorant:.3f}; grid {g.n_levels}x{g.n_features_per_level}, "
        f"2^{g.log2_hashmap_size} rows, batch {eng.batch_size}")
    check(tuple(eng.gt_density.shape) == (VOLUME_RES,) * 3 + (1,) and g.n_levels == 8
          and g.n_features_per_level == 4 and g.log2_hashmap_size == 19
          and eng.batch_size == 1 << 16, "volume mode is not at the configuration's full width")
    check(torch.equal(eng.gt_density[..., 0].cpu(), torch.from_numpy(vol.density)),
          "the .nvdb did not load as written")
    ms, losses = bundles_ms(lambda: sess.train(16), VOLUME_BUNDLES, 16)
    stats = {"sync_phases": True}
    sess.state, _ = eng.train_bundle(sess.state, sess._generator, stats=stats)
    sess.training_step += 16
    out["split_ms"] = phase_split(stats, 16)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out.update(ms_per_step=statistics.median(ms), ms_runs=[round(x, 2) for x in ms],
               loss_first_last=(losses[0], losses[-1]))
    log(f"[volume] {VOLUME_BUNDLES} bundles of 16 steps: {out['ms_per_step']:.2f} ms a step "
        f"(median; bundles {out['ms_runs']}), loss {losses[0]:.5f} -> {losses[-1]:.5f}; a "
        f"synced bundle a step: {out['split_ms']} ms; peak memory {out['peak_mem_gb']:.2f} GB")
    check(np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0],
          "volume: the loss did not halve")
    cam = look_at_matrix(VOLUME_EYE, [0.5, 0.5, 0.5])
    focal = (VOLUME_FOCAL, VOLUME_FOCAL)
    frames = {}
    for use_gt in (True, False):
        st = {}
        box = []
        ms_f = sync_ms(lambda: box.append(sess.render(WIDTH, HEIGHT, cam, focal, spp=VOLUME_SPP,
                                                      use_gt=use_gt, stats=st)))
        frames[use_gt] = box[0]
        out["gt" if use_gt else "network"] = {"frame_ms": ms_f, "march_iters": st["march_iters"]}
    sstats = {"sync_phases": True}
    sess.render(WIDTH, HEIGHT, cam, focal, spp=1, stats=sstats)
    out["frame_split_ms_spp1"] = phase_split(sstats)
    h2, w2 = HEIGHT // 2, WIDTH // 2
    centre = {k: float(f[h2 - 16:h2 + 16, w2 - 16:w2 + 16, 3].mean()) for k, f in frames.items()}
    corner = {k: float(f[:16, :16, 3].mean()) for k, f in frames.items()}
    out.update(centre_opacity={"gt": centre[True], "network": centre[False]},
               corner_opacity={"gt": corner[True], "network": corner[False]})
    log(f"[volume] {WIDTH}x{HEIGHT} spp {VOLUME_SPP}: use_gt {out['gt']['frame_ms']:.1f} ms "
        f"({out['gt']['march_iters']} delta-tracking iterations), network "
        f"{out['network']['frame_ms']:.1f} ms ({out['network']['march_iters']}); synced spp 1 "
        f"network frame: {out['frame_split_ms_spp1']} ms; opacity centre / corner: use_gt "
        f"{centre[True]:.3f} / {corner[True]:.3f}, network {centre[False]:.3f} / "
        f"{corner[False]:.3f}")
    for f in frames.values():
        check(f.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(f).all()),
              "volume frame: shape or non-finite values")
    check(centre[True] > 0.5 and centre[False] > 0.3 and corner[True] < 0.2
          and corner[False] < 0.2, "volume: the frames' centre and corner opacities")
    # the card against the CPU: a small frame on the same draws, one step
    params = sess.render_params()
    ceng = on_cpu(eng, gt_density=eng.gt_density)
    pc = tree_map(lambda x: x.cpu(), params)
    gen, cache = torch.Generator().manual_seed(5), []

    def draws_on(d):
        def draw(_pass, i, n):
            while len(cache) <= i:
                u = torch.rand((n,), generator=gen)
                cache.append((1e-7 + u * (1.0 - 1e-7), torch.rand((n,), generator=gen)))
            return tuple(x.to(d) for x in cache[i])
        return draw

    sw, sh = VOLUME_SMALL
    small_focal = (VOLUME_FOCAL * sw / WIDTH,) * 2
    a, aa = eng.render_frame(params, sw, sh, cam, small_focal, spp=1, draw=draws_on(dev))
    b, ba = ceng.render_frame(pc, sw, sh, cam, small_focal, spp=1,
                              draw=draws_on(torch.device("cpu")))
    differ = (aa.cpu() != ba)
    close = torch.isclose(a.cpu(), b, **STEP_MLP_TOL).all(dim=-1)[~differ]
    out["cpu_frame"] = {"hits_differ": float(differ.float().mean()),
                        "close": float(close.float().mean())}
    log(f"[volume] {sw}x{sh} card vs CPU on the same draws: hits differ on "
        f"{100 * out['cpu_frame']['hits_differ']:.2f} % of pixels, colours within rtol 1e-2 / "
        f"atol 1e-3 on {100 * out['cpu_frame']['close']:.2f} % of the others")
    check(out["cpu_frame"]["hits_differ"] <= 0.005 and out["cpu_frame"]["close"] >= 0.99,
          "volume: the card frame is not the CPU's")
    pos = torch.rand((MODE_CHECK_BATCH, 3), generator=torch.Generator().manual_seed(7))
    engs = [ceng, eng]
    out["card_vs_cpu"] = card_vs_cpu_step(
        "volume", lambda prm, d: engs[d != torch.device("cpu")].loss_and_grads(prm, pos.to(d)),
        tree_map(lambda x: x.cpu(), sess.state["params"]), dev)
    out["launches"] = kernel_counts()
    return out


def mesh_phase(fox, sdf, tmp: Path) -> dict:
    """Session.save_mesh at MESH_RES^3 on the trained SDF (its zero level)
    and on the fox (density 2.5, vertex colours and normals), then
    MESH_OPT_STEPS optimise_mesh_step: counts, times, and a closed surface:
    every edge shared by an even number of faces (two, or four where two
    sheets touch along it), except where the surface leaves the grid (the
    fox capture's walls and table reach its box)."""
    import numpy as np

    out = {}
    zero_kernel_counts()
    # the fox's mesh (~10 M vertices: the capture's background too) as
    # binary PLY; OBJ text of that size takes minutes to format
    for name, sess, path in (("sdf", sdf, tmp / "sdf.obj"), ("fox", fox, tmp / "fox.ply")):
        t = time.perf_counter()
        verts, faces = sess.save_mesh(path, resolution=MESH_RES)
        save_s = time.perf_counter() - t
        edges = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
                        axis=1).astype(np.int64)
        keys, uses = np.unique(edges[:, 0] * len(verts) + edges[:, 1], return_counts=True)
        odd = keys[uses % 2 == 1]
        open_v = np.unique(np.concatenate([odd // len(verts), odd % len(verts)]))
        amin, adiag = (np.asarray(x, np.float32) for x in (sess.mesh["amin"], sess.mesh["adiag"]))
        cell = adiag / MESH_RES  # vertices of the outermost cells lie within 1.5 cells of the box
        on_border = ((verts[open_v] < amin + 1.5 * cell) | (verts[open_v] > amin + adiag - 1.5 * cell)
                     ).any(axis=1)
        t = time.perf_counter()
        moved = sess.optimise_mesh_step(n_steps=MESH_OPT_STEPS)
        opt_s = time.perf_counter() - t
        shift = float(np.abs(moved - verts).max())
        out[name] = {"verts": len(verts), "faces": len(faces),
                     "open_edges": int((uses % 2 == 1).sum()),
                     "four_face_edges": int((uses == 4).sum()), "save_s": save_s,
                     "optimise_s": opt_s, "max_shift": shift}
        log(f"[mesh] {name}: {len(verts)} vertices, {len(faces)} faces, "
            f"{out[name]['open_edges']} edges of one face (all at the grid's border: "
            f"{bool(on_border.all())}), {out[name]['four_face_edges']} of four; save_mesh at "
            f"{MESH_RES}^3 {save_s:.2f} s, "
            f"{MESH_OPT_STEPS} optimise_mesh_step {opt_s:.2f} s (largest move {shift:.3g})")
        check(len(faces) > 1000 and bool(on_border.all()), f"mesh {name}: not a closed surface")
        check(np.isfinite(moved).all() and 0 < shift < 0.05, f"mesh {name}: refinement")
    with open(tmp / "fox.ply", "rb") as f:
        head = f.read(1024).split(b"end_header")[0].decode()
    check("property uchar red" in head and "property float nx" in head
          and f"element vertex {out['fox']['verts']}" in head,
          "the fox mesh lacks vertex colours or normals")
    check(len(open(tmp / "sdf.obj").readline().split()) == 4, "the SDF mesh file")
    out["launches"] = kernel_counts()
    return out


def configs_phase(fox, rows, scale, n_live, dev, cuda_ms, general_ptxas: dict) -> dict:
    """Every configs/nerf/*.json at full width from a seeded init, with the
    fox's occupancy bitfield: a bake at CONFIG_BAKE_RES, a 320x180 sweep
    frame through K1 and K2 against the plain frame (each config's
    launches counted from 0), K1 against shade_volume_plain on the bake's
    rows; then K1's general path on the fox's R=256 rows with the colour
    MLPs of CONFIG_TIMED and K1_WIDEST, timed beside its bound and in turns
    with the wide kernel (the general path's first kernel), on K1_WIDE
    through the wide kernel, and on the
    fox's own 32-64-64-3 beside the tuned path, after a probe of one tile
    through both of their tensor-core instructions.  `general_ptxas` maps
    (padded width, warps a block) of each general instance to ptxas's
    report of it."""
    import numpy as np
    import torch

    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.engines.nerf_sweep import _fused_prep_eligible, render_frame_sweep
    from sienerf_torch.io.nerf_dataset import NerfDataset
    from sienerf_torch.models.nerf_network import init_nerf_network
    from sienerf_torch.ops.mlp import mlp_layer_dims
    from sienerf_torch.ops.shade import (
        _shade_general,
        _shade_wide,
        general_occupancy,
        general_width,
        mma_probe,
        shade_mlp_layout,
        shade_volume,
        shade_volume_plain,
    )
    from sienerf_torch.utils.camera import look_at_matrix
    from sienerf_torch.utils.config import load_network_config

    out = {"by_config": {}}
    bitfield = fox.state["occ"]["bitfield"]
    cam = look_at_matrix(EYES[0], [0.5, 0.5, 0.5])
    sw, sh = CONFIG_SMALL
    focal_s = tuple(f * sw / WIDTH for f in FOCAL)
    weights = {}
    for path in sorted((ROOT / "configs" / "nerf").glob("*.json")):
        name = path.stem
        t = time.perf_counter()
        cfg = load_network_config(path)
        eng = NerfEngine.create(cfg, NerfDataset.placeholder(4.0), device=dev)
        check((eng.occ.n_cascades, eng.occ.grid_size) == tuple(bitfield.shape[:2]),
              f"[configs] {name}: the occupancy grid is not the fox's")
        params = init_nerf_network(eng.net, torch.Generator(device=dev).manual_seed(0), dev)
        weights[name] = (params["rgb_mlp"], eng.net.rgb_mlp)
        grid, meta = eng.bake_features(params, {"bitfield": bitfield},
                                       resolution=CONFIG_BAKE_RES)
        torch.cuda.synchronize()
        bake_s = time.perf_counter() - t
        check(_fused_prep_eligible(eng, grid), f"[configs] {name}: K1 does not take it")
        zero_kernel_counts()
        t = time.perf_counter()
        img, _ = render_frame_sweep(eng, params, grid, meta, cam, focal_s, width=sw, height=sh)
        torch.cuda.synchronize()
        frame_ms = 1e3 * (time.perf_counter() - t)
        launches = kernel_counts()
        check(launches["shade"] == 1 and launches["sweep"] == 1,
              f"[configs] {name}: launches {launches}")
        ref, _ = render_frame_sweep(eng, params, grid, meta, cam, focal_s, width=sw,
                                    height=sh, impl="plain")
        f_err = compare(f"[configs] {name} frame vs plain", img, ref, **FRAME_TOL)
        R, K = meta["resolution"], meta["n_cascades"]
        kw = dict(resolution=R, n_cascades=K, density_act=eng.net.density_activation,
                  rgb_act=eng.net.rgb_activation, rgb_mlp=eng.net.rgb_mlp)
        o = torch.as_tensor(np.asarray(cam, np.float32)[:3, 3], device=dev)
        vol = shade_volume(grid["rows"], grid["scale"], o, params["rgb_mlp"], **kw)
        torch.cuda.synchronize()
        k1_err = compare(f"[configs] {name} K1 vs plain", vol,
                         shade_volume_plain(grid["rows"], grid["scale"], o, params["rgb_mlp"],
                                            **kw), **K1_TOL)
        kept = int((grid["rows"][:, 0] != -32768).sum())
        out["by_config"][name] = {
            "rgb_mlp": [list(d) for d in mlp_layer_dims(eng.net.rgb_mlp)],
            "pos_otype": eng.net.pos_otype, "bake_s": bake_s, "kept": kept,
            "frame_ms": frame_ms, "launches": launches, "k1_max_abs_err": k1_err,
            "frame_max_abs_err": f_err, "mean_alpha": float(img[..., 3].mean())}
        log(f"[configs] {name}: colour MLP {mlp_layer_dims(eng.net.rgb_mlp)}, "
            f"{eng.net.pos_otype}; bake R={R} {bake_s:.2f} s ({kept} kept); {sw}x{sh} sweep "
            f"frame {frame_ms:.1f} ms, launches K1 {launches['shade']} K2 {launches['sweep']}, "
            f"mean alpha {float(img[..., 3].mean()):.3f}")
        del eng, params, grid, img, ref, vol
        torch.cuda.empty_cache()
    out["k1_max_abs_err"] = max(c["k1_max_abs_err"] for c in out["by_config"].values())
    out["launches"] = {k: sum(c["launches"][k] for c in out["by_config"].values())
                       for k in ("shade", "sweep", "gather_rows", "gather_small")}

    # the two instructions of K1's paths on one tile: mma.sync (the tuned
    # kernel) and wgmma (the general kernel) on the same bf16 inputs
    gen = torch.Generator(device=dev).manual_seed(2)
    differ, worst = 0, 0.0
    for trial in range(8):
        a = (torch.randn((64, 64), generator=gen, device=dev) * (1 + trial)).to(torch.bfloat16)
        b = torch.randn((64, 64), generator=gen, device=dev).to(torch.bfloat16)
        d_sync, d_wgmma = mma_probe(a, b)
        torch.cuda.synchronize()
        differ += int((d_sync.view(torch.int32) != d_wgmma.view(torch.int32)).sum())
        worst = max(worst, float((d_sync - d_wgmma).abs().max()))
    out["mma_probe"] = {"outputs": 8 * 64 * 64, "differ": differ, "largest": worst}
    log(f"[configs] probe, one 64x64x64 bf16 product a trial through mma.sync and wgmma: "
        f"{differ} of {8 * 64 * 64} f32 outputs differ in their bits (largest {worst:.3g})")

    # K1's general path at the fox's R=256 bake
    R, K = BAKE_RES, scale.shape[0]
    Rv = R + 1
    o = torch.as_tensor(np.asarray(cam, np.float32)[:3, 3], device=dev)
    acts = dict(density_act=fox.engine.net.density_activation,
                rgb_act=fox.engine.net.rgb_activation)
    # the general path on the fox's own 32-64-64-3: the tuned path's bits,
    # timed beside the tuned path in turns
    fws, fmlp = fox.state["params"]["rgb_mlp"], fox.engine.net.rgb_mlp
    kw = dict(resolution=R, n_cascades=K, rgb_mlp=fmlp, **acts)
    tuned = shade_volume(rows, scale, o, fws, **kw)
    general = _shade_general(rows, scale, o, fws, **kw)
    torch.cuda.synchronize()
    out["fox_general_equal"] = bool(torch.equal(tuned.contiguous().view(torch.int16),
                                                general.contiguous().view(torch.int16)))
    del tuned, general
    fox_ms = {"general": [], "tuned": []}
    for who in ("tuned", "general", "general", "tuned"):
        fn = _shade_general if who == "general" else shade_volume
        fox_ms[who] += [cuda_ms(lambda: fn(rows, scale, o, fws, **kw), 1, warmup=1)
                        for _ in range(5)]
    out["fox_general_ms"] = statistics.median(fox_ms["general"])
    out["fox_tuned_ms"] = statistics.median(fox_ms["tuned"])
    log(f"[configs] K1's general path on the fox's 32-64-64-3 at R={R}: bit-equal to the "
        f"tuned path {out['fox_general_equal']}, {out['fox_general_ms']:.3f} ms against the "
        f"tuned path's {out['fox_tuned_ms']:.3f} ms (medians of ten, in turns)")
    check(out["fox_general_equal"], "[configs] the general path differs from the tuned one")
    out["timed"] = {}
    rng = np.random.default_rng(0)
    widest = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)).to(dev)
              for a, b in K1_WIDEST]
    timed = [(name, *weights[name]) for name in CONFIG_TIMED]
    timed.append(("32-128x4-3", widest, None))
    for name, ws, mlp in timed:
        n_hidden, width = shade_mlp_layout([w.shape for w in ws])
        kw = dict(resolution=R, n_cascades=K, rgb_mlp=mlp, **acts)
        vol = shade_volume(rows, scale, o, ws, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = shade_volume_plain(rows, scale, o, ws, **kw)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t)  # the one plain call the check needs
        err = compare(f"[configs] {name} K1 vs plain at the fox's R={R}", vol, want, **K1_TOL)
        del vol
        wide = _shade_wide(rows, scale, o, ws, **kw)
        torch.cuda.synchronize()
        wide_err = compare(f"[configs] {name} K1's wide kernel vs plain at the fox's R={R}",
                           wide, want, **K1_TOL)
        del wide, want
        # the general kernel and the wide one (the floor: the general path's
        # first kernel) in turns, five timings each a turn
        by = {"general": [], "wide": []}
        for who in ("general", "wide", "wide", "general"):
            fn = shade_volume if who == "general" else _shade_wide
            by[who] += [cuda_ms(lambda: fn(rows, scale, o, ws, **kw), 1, warmup=1)
                        for _ in range(5)]
        times = by["general"]
        # bytes as the fox's K1 (a kept row 32 bytes, a culled one its
        # sentinel, 8 bytes out a vertex); flops of the MLP's own layers on
        # this bake's kept vertices, as K1_FLOPS_PER_VERTEX counts the fox's
        # (not the kernel's padding of the 3 outputs to one n8 tile)
        flops = 2 * sum(w.shape[0] * w.shape[1] for w in ws)
        nbytes = (n_live * 32 + (rows.shape[0] - n_live) * 2 + K * Rv ** 3 * 8
                  + scale.numel() * 4 + 12 + sum(w.numel() for w in ws) * 2)
        tb, to = 1e3 * nbytes / HBM_BPS, 1e3 * n_live * flops / BF16_FLOPS
        warps, blocks, smem = general_occupancy(ws)
        instance = general_width(width) if n_hidden else 32
        ptxas = general_ptxas.get((instance, warps), "")
        out["timed"][name] = {
            "rgb_mlp": [list(w.shape) for w in ws],
            "ms": statistics.median(times), "ms_range": (min(times), max(times)),
            "plain_ms": plain_ms, "max_abs_err": err, "bytes": nbytes,
            "flops_per_vertex": flops, "tflop": n_live * flops / 1e12,
            "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "bytes_ms": tb, "flops_ms": to, "warps_a_block": warps, "blocks_an_sm": blocks,
            "smem_bytes": smem, "kernel_width": instance, "ptxas": ptxas,
            "wide_ms": statistics.median(by["wide"]), "wide_max_abs_err": wide_err}
        log(f"[configs] K1 {name} ({n_hidden} hidden x {width}) on the fox's R={R} rows "
            f"({n_live} kept): {statistics.median(times):.3f} ms (ten timings "
            f"{min(times):.3f}-{max(times):.3f}; plain {plain_ms:.1f} ms); bound "
            f"{max(tb, to):.3f} ms ({'bytes' if tb >= to else 'operations'}: "
            f"{nbytes / 1e9:.3f} GB -> {tb:.3f} ms, {flops} flops a kept vertex, "
            f"{n_live * flops / 1e12:.3f} TFLOP -> {to:.3f} ms; "
            f"{100 * max(tb, to) / statistics.median(times):.1f} % of it); width-{instance} "
            f"kernel, {warps} warps a block, {blocks} blocks an SM, {smem} bytes of shared "
            f"memory; {ptxas}; the wide kernel in turns {statistics.median(by['wide']):.3f} "
            f"ms")
    # a net above width 256 takes the wide kernel
    ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32)).to(dev)
          for a, b in K1_WIDE]
    kw = dict(resolution=R, n_cascades=K, **acts)
    n0 = shade_volume.launches
    vol = shade_volume(rows, scale, o, ws, **kw)
    torch.cuda.synchronize()
    check(shade_volume.launches == n0 + 1, "[configs] K1 32-512-3: not one launch")
    err = compare(f"[configs] 32-512-3 K1 (wide kernel) vs plain at the fox's R={R}", vol,
                  shade_volume_plain(rows, scale, o, ws, **kw), **K1_TOL)
    del vol
    ms = statistics.median([cuda_ms(lambda: shade_volume(rows, scale, o, ws, **kw), 1,
                                    warmup=1) for _ in range(5)])
    warps, blocks, smem = general_occupancy(ws)
    out["wide"] = {"rgb_mlp": [list(w.shape) for w in ws], "ms": ms, "max_abs_err": err,
                   "warps_a_block": warps, "blocks_an_sm": blocks, "smem_bytes": smem}
    log(f"[configs] K1 32-512-3 on the fox's R={R} rows through the wide kernel: {ms:.3f} ms, "
        f"{warps} warps a block, {blocks} blocks an SM, {smem} bytes of shared memory")
    return out


def takikawa_phase(dev, obj: Path) -> dict:
    """configs/sdf/takikawa.json (the octree at depth 10, levels 4-9
    encoded) on the [sdf] phase's OBJ through Session.load_file: the
    octree, steps, IoU, one injected step against the CPU, a 720p frame."""
    import numpy as np
    import torch

    from sienerf_torch.ops.optim import tree_map
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    out = {}
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t = time.perf_counter()
    sess = Session(device=dev)
    sess.load_file(obj, network=ROOT / "configs" / "sdf" / "takikawa.json")
    out["load_s"] = time.perf_counter() - t
    eng = sess.engine
    out["octree"] = dict(eng.octree_stats)
    log(f"[takikawa] {obj.name} loaded in {out['load_s']:.2f} s: octree depth "
        f"{out['octree']['depth']}, {out['octree']['nodes']} nodes, "
        f"{out['octree']['vertices']} vertices ({4 * 8 * out['octree']['vertices'] / 1e6:.1f} "
        f"MB of f32 features), built in {out['octree']['build_s']:.2f} s; MLP input "
        f"{eng.net.mlp.n_input_dims}, batch {eng.batch_size}")
    check(out["octree"]["depth"] == 10 and eng.net.mlp.n_input_dims == 48
          and eng.batch_size == 1 << 16, "[takikawa] not at the configuration's full width")
    iou0 = sess.calculate_iou(SDF_IOU_RES)
    ms, losses = bundles_ms(lambda: sess.train(16), TAKIKAWA_BUNDLES, 16)
    stats = {"sync_phases": True}
    sess.state, _ = eng.train_bundle(sess.state, sess._generator, stats=stats)
    sess.training_step += 16
    out["split_ms"] = phase_split(stats, 16)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    iou1 = sess.calculate_iou(SDF_IOU_RES)
    out.update(ms_per_step=statistics.median(ms), ms_runs=[round(x, 2) for x in ms],
               loss_first_last=(losses[0], losses[-1]), iou_untrained=iou0, iou=iou1)
    log(f"[takikawa] {TAKIKAWA_BUNDLES} bundles of 16 steps: {out['ms_per_step']:.2f} ms a "
        f"step (median; bundles {out['ms_runs']}), loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
        f"a synced bundle a step: {out['split_ms']} ms; peak memory "
        f"{out['peak_mem_gb']:.2f} GB; IoU at {SDF_IOU_RES}^3 {iou0:.4f} -> {iou1:.4f} "
        f"after {sess.training_step} steps")
    check(np.isfinite(losses).all() and iou1 > iou0, "[takikawa] the IoU did not rise")
    pos, tgt = eng.draw_bundle(torch.Generator(device=dev).manual_seed(6), 1)
    pos, tgt = pos[0, :MODE_CHECK_BATCH].cpu(), tgt[0, :MODE_CHECK_BATCH].cpu()
    ceng = on_cpu(eng, bvh_dev=eng.bvh_dev, tri_normals=eng.tri_normals, tri_cdf=eng.tri_cdf,
                  tak_tables=eng.tak_tables)
    engs = [ceng, eng]
    out["card_vs_cpu"] = card_vs_cpu_step(
        "takikawa", lambda prm, d: engs[d != torch.device("cpu")].loss_and_grads(
            prm, pos.to(d), tgt.to(d)),
        tree_map(lambda x: x.cpu(), sess.state["params"]), dev)
    cam = look_at_matrix(SDF_EYE, [0.5, 0.5, 0.5])
    fstats = {}
    box = []
    out["frame_ms"] = sync_ms(lambda: box.append(sess.render(WIDTH, HEIGHT, cam, stats=fstats)))
    sstats = {"sync_phases": True}
    sess.render(WIDTH, HEIGHT, cam, stats=sstats)
    out["frame_split_ms"] = phase_split(sstats)
    out["trace_iters"] = fstats["trace_iters"]
    frame = box[0]
    hit = float((frame[..., :3] != 1.0).any(dim=-1).float().mean())
    log(f"[takikawa] {WIDTH}x{HEIGHT} frame, shadows on: {out['frame_ms']:.1f} ms "
        f"({out['trace_iters']} sphere-trace iterations); synced: {out['frame_split_ms']} ms; "
        f"{100 * hit:.1f} % of pixels hit")
    # a field this briefly trained may be hit by every ray (its distances
    # are small everywhere): the share is recorded, the frame must not be
    # empty
    out["hit_share"] = hit
    check(frame.shape == (HEIGHT, WIDTH, 4) and bool(torch.isfinite(frame).all())
          and hit > 0.05, "[takikawa] frame: empty or not finite")
    out["launches"] = kernel_counts()
    return out


def fine_phase(tr, cam, dev) -> dict:
    """The fine render grid of the trained student: bake_render_grid at
    factor FINE_FACTOR, then the tile-2^17 live frame with and without it,
    and a FINE_CPU_SMALL frame through it against the same code on the CPU."""
    import torch

    from sienerf_torch import metrics
    from sienerf_torch.ops.optim import inference_params, tree_map

    out = {}
    eng, state = tr["engine"], tr["state"]
    params = inference_params(state["opt"], state["params"])
    torch.cuda.synchronize()
    t = time.perf_counter()
    fine = eng.bake_render_grid(params, state["occ"], factor=FINE_FACTOR)
    torch.cuda.synchronize()
    out["bake_s"] = time.perf_counter() - t
    out["occupied"] = float(fine.float().mean())
    out["coarse_occupied"] = float(state["occ"]["bitfield"].float().mean())
    log(f"[fine] bake_render_grid(factor={FINE_FACTOR}): {tuple(fine.shape)} in "
        f"{out['bake_s']:.2f} s, {100 * out['occupied']:.3f} % of fine voxels occupied "
        f"(the training grid {100 * out['coarse_occupied']:.3f} %)")
    frames = {}
    fw, fh = FINE_FRAME
    focal_f = tuple(f * fw / WIDTH for f in FOCAL)
    for tag, fb in (("coarse", None), ("fine", fine)):
        stats = {}
        box = []
        ms = sync_ms(lambda: box.append(eng.render_frame(
            params, state["occ"]["bitfield"], fw, fh, cam, focal_f, tile=LIVE_BIG_TILE,
            fine_bitfield=fb, stats=stats)[0]))
        frames[tag] = box[0]
        out[tag] = {"ms": ms, "samples": stats["samples"], "rounds": stats["rounds"]}
        check(bool(torch.isfinite(box[0]).all()), f"[fine] {tag} frame not finite")
    out["psnr_db"] = float(metrics.psnr(frames["fine"][..., :3], frames["coarse"][..., :3]))
    log(f"[fine] tile-2^17 {fw}x{fh} live frame of the trained student: coarse grid "
        f"{out['coarse']['ms']:.1f} ms, {out['coarse']['samples']} samples, "
        f"{out['coarse']['rounds']} rounds; fine grid {out['fine']['ms']:.1f} ms, "
        f"{out['fine']['samples']} samples, {out['fine']['rounds']} rounds; PSNR between the "
        f"two {out['psnr_db']:.2f} dB")
    check(out["fine"]["samples"] < out["coarse"]["samples"], "[fine] no sample was culled")

    # the same port code on the CPU, at FINE_CPU_SMALL, through the same fine grid
    sw, sh = FINE_CPU_SMALL
    focal_s = tuple(f * sw / WIDTH for f in FOCAL)
    card = eng.render_frame(params, state["occ"]["bitfield"], sw, sh, cam, focal_s,
                            fine_bitfield=fine)[0].cpu()
    t = time.perf_counter()
    on_host = on_cpu(eng).render_frame(
        tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, params),
        state["occ"]["bitfield"].cpu(), sw, sh, cam, focal_s, fine_bitfield=fine.cpu())[0]
    out["cpu_s"] = time.perf_counter() - t
    out["cpu_agree"] = frame_agreement(f"[fine] {sw}x{sh} fine-grid frame card vs CPU", card,
                                       on_host)
    log(f"[fine] {sw}x{sh} fine-grid frame card vs CPU ({out['cpu_s']:.1f} s on the CPU): "
        f"{100 * out['cpu_agree']:.2f} % of pixels agree, PSNR "
        f"{metrics.psnr(card[..., :3], on_host[..., :3]):.2f} dB")
    check(out["cpu_agree"] >= LIVE_MIN_AGREE, f"[fine] {sw}x{sh}: only "
          f"{100 * out['cpu_agree']:.2f} % of pixels agree with the CPU frame")
    return out


def triplane_phase(tr, fox_bitfield, dev) -> dict:
    """configs/nerf/tensor.json (three 2-D hash grids) at full width from a
    seeded init: one injected training step card vs CPU on the [train]
    views, a live and a sweep frame at 320x180 with K1 and K2 held to
    their plain versions."""
    import torch

    from sienerf_torch import metrics
    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.engines.nerf_sweep import axis_view, render_frame_sweep, sweep_geometry
    from sienerf_torch.ops.optim import tree_map
    from sienerf_torch.ops.shade import shade_volume, shade_volume_plain
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel, sweep_composite_plain
    from sienerf_torch.utils.camera import look_at_matrix
    from sienerf_torch.utils.config import load_network_config

    out = {}
    cfg = load_network_config(ROOT / "configs" / "nerf" / "tensor.json")
    ds = tr["dataset"]
    few = dataclasses.replace(ds, images=ds.images[:TRAIN_CHECK_VIEWS],
                              xforms=ds.xforms[:TRAIN_CHECK_VIEWS],
                              focal_lengths=ds.focal_lengths[:TRAIN_CHECK_VIEWS],
                              principal_points=ds.principal_points[:TRAIN_CHECK_VIEWS])
    ceng = NerfEngine.create(cfg, few, train_batch_size=TRAIN_CHECK_BATCH, device=dev)
    peng = NerfEngine.create(cfg, few, train_batch_size=TRAIN_CHECK_BATCH, device="cpu")
    g = ceng.net.grid
    log(f"[triplane] {len(g)} planes of {g[0].n_levels}x{g[0].n_features_per_level}, "
        f"2^{g[0].log2_hashmap_size} rows; density MLP input {ceng.net.density_mlp.n_input_dims}")
    check(ceng.net.pos_otype == "triplane" and len(g) == 3 and g[0].log2_hashmap_size == 17,
          "[triplane] not at the configuration's full width")
    state = ceng.init(0)
    state["occ"] = dict(state["occ"], bitfield=fox_bitfield.clone())
    ceng._mean_samples = peng._mean_samples = tr["engine"]._mean_samples
    n_rays, k, iters = ceng._phase_geometry()
    draws = peng.draw_step(torch.Generator().manual_seed(1), n_rays, int(state["step"]))
    cpu_state = tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, state)
    loss_c, grads_c, _ = ceng.loss_and_grads(state, tree_map(lambda x: x.to(dev), draws), k,
                                             iters)
    loss_p, grads_p, _ = peng.loss_and_grads(cpu_state, draws, k, iters)
    rel = abs(float(loss_c) / float(loss_p) - 1)
    worst = 0.0
    for name in ("density_mlp", "rgb_mlp", "grid"):
        for i, (a, b) in enumerate(zip(grads_c[name], grads_p[name])):
            share = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            worst = max(worst, share)
            check(share <= STEP_MAX_SHARE, f"[triplane] {name}[{i}] gradient {share:.3g}")
    out["card_vs_cpu"] = {"loss_card": float(loss_c), "loss_cpu": float(loss_p),
                          "loss_rel": rel, "grad_worst_share": worst}
    log(f"[triplane] card step vs CPU at {n_rays} rays x k {k}: loss {float(loss_c):.8f} vs "
        f"{float(loss_p):.8f} (relative {rel:.2e}), gradients within {100 * worst:.3f} % "
        f"of their largest entry")
    check(rel <= STEP_LOSS_RTOL, f"[triplane] card step loss: relative {rel:.3g}")
    del peng, cpu_state, grads_c, grads_p
    # frames at 320x180 from the seeded field on the fox's occupancy
    params = state["params"]
    cam = look_at_matrix(EYES[0], [0.5, 0.5, 0.5])
    sw, sh = CONFIG_SMALL
    focal_s = tuple(f * sw / WIDTH for f in FOCAL)
    live = ceng.render_frame(params, state["occ"]["bitfield"], sw, sh, cam, focal_s)[0]
    check(bool(torch.isfinite(live).all()), "[triplane] live frame not finite")
    t = time.perf_counter()
    grid, meta = ceng.bake_features(params, state["occ"], resolution=BAKE_RES)
    torch.cuda.synchronize()
    out["bake_s"] = time.perf_counter() - t
    zero_kernel_counts()
    img, _ = render_frame_sweep(ceng, params, grid, meta, cam, focal_s, width=sw, height=sh)
    torch.cuda.synchronize()
    out["launches"] = kernel_counts()
    check(out["launches"]["shade"] == 1 and out["launches"]["sweep"] == 1,
          f"[triplane] launches {out['launches']}")
    ref, _ = render_frame_sweep(ceng, params, grid, meta, cam, focal_s, width=sw, height=sh,
                                impl="plain")
    compare("[triplane] sweep frame vs plain", img, ref, **FRAME_TOL)
    R, K = meta["resolution"], meta["n_cascades"]
    geo = sweep_geometry(ceng, cam, focal_s, width=sw, height=sh, device=dev)
    kw = dict(resolution=R, n_cascades=K, density_act=ceng.net.density_activation,
              rgb_act=ceng.net.rgb_activation, rgb_mlp=ceng.net.rgb_mlp)
    vol = shade_volume(grid["rows"], grid["scale"], geo["o"][0], params["rgb_mlp"], **kw)
    torch.cuda.synchronize()
    out["k1_max_abs_err"] = compare(
        "[triplane] K1 vs plain", vol, shade_volume_plain(
            grid["rows"], grid["scale"], geo["o"][0], params["rgb_mlp"], **kw), **K1_TOL)
    near = max(0.05, ceng.near_distance)
    args = (axis_view(vol, geo["axis"]), geo["o_c"], geo["eb"], geo["ec"], near,
            ceng.render_min_transmittance)
    kk = dict(resolution=R, n_cascades=K, data_flip=geo["flip"])
    got = sweep_composite_kernel(*args, **kk)
    torch.cuda.synchronize()
    want = sweep_composite_plain(*args, **kk)
    out["k2_max_abs_err"] = max(compare(f"[triplane] K2 {n} vs plain", a, b, **K2_TOL)
                                for n, a, b in zip(("C", "opacity", "T", "depth_t"), got,
                                                   want))
    out["mean_alpha"] = {"sweep": float(img[..., 3].mean()), "live": float(live[..., 3].mean())}
    out["sweep_vs_live_psnr_db"] = float(metrics.psnr(img[..., :3], live[..., :3]))
    log(f"[triplane] bake R={R} {out['bake_s']:.2f} s; {sw}x{sh} frames: sweep mean alpha "
        f"{out['mean_alpha']['sweep']:.3f}, live {out['mean_alpha']['live']:.3f}; PSNR sweep "
        f"vs live {out['sweep_vs_live_psnr_db']:.2f} dB")
    return out


def png_phase(tr, net_config: dict, dev, tmp: Path) -> dict:
    """The [train] phase's training views written as 8-bit RGBA PNGs with a
    transforms.json, loaded by Session.load_file (the port's PNG decoder),
    trained PNG_STEPS steps through Session.train, and compare_view(0)."""
    import concurrent.futures as futures
    import json as _json

    import numpy as np
    import torch

    from sienerf_torch.io.image_io import load_image
    from sienerf_torch.io.nerf_dataset import ngp_matrix_to_nerf
    from sienerf_torch.io.png import read_png, write_png
    from sienerf_torch.session import Session

    out = {"imports": {}}
    for mod in ("PIL", "torchvision.io", "cv2"):
        try:
            __import__(mod)
            out["imports"][mod] = True
        except Exception:  # noqa: BLE001 - only recorded
            out["imports"][mod] = False
    seen = ", ".join(f"{k} {'imports' if v else 'absent'}" for k, v in out["imports"].items())
    log(f"[png] {seen} (the port reads PNG with none of them)")
    ds = tr["dataset"]
    n = min(PNG_VIEWS, ds.images.shape[0])
    root = tmp / "png_scene"
    root.mkdir()
    q = np.clip(np.rint(ds.images[:n] * 255.0), 0, 255).astype(np.uint8)
    scale, offset = 0.33, np.asarray([0.5, 0.5, 0.5], np.float32)
    frames = []
    for i in range(n):
        m = np.eye(4, dtype=np.float32)
        m[:3] = ngp_matrix_to_nerf(ds.xforms[i], scale, offset)
        frames.append({"file_path": f"v{i:03d}", "transform_matrix": m.tolist()})
    t = time.perf_counter()
    with futures.ThreadPoolExecutor(max_workers=8) as ex:
        list(ex.map(lambda i: write_png(root / f"v{i:03d}.png", q[i], level=1), range(n)))
    out["write_s"] = time.perf_counter() - t
    meta = {"fl_x": float(ds.focal_lengths[0, 0]), "fl_y": float(ds.focal_lengths[0, 1]),
            "w": WIDTH, "h": HEIGHT, "aabb_scale": 4, "scale": scale,
            "offset": offset.tolist(), "frames": frames}
    (root / "transforms.json").write_text(_json.dumps(meta))
    (tmp / "png_net.json").write_text(_json.dumps(net_config))
    t = time.perf_counter()
    with futures.ThreadPoolExecutor(max_workers=16) as ex:
        list(ex.map(lambda i: read_png(root / f"v{i:03d}.png"), range(n)))
    out["decode_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sess = Session(device=dev)
    sess.load_file(root, network=tmp / "png_net.json", train_batch_size=TRAIN_BATCH)
    out["load_s"] = time.perf_counter() - t
    got = sess.engine.images
    want = q.astype(np.float32) / 255.0
    check(got.shape == want.shape and np.array_equal(got, want),
          "[png] the loaded images are not the views quantised to 8 bits")
    check(np.allclose(sess.engine.xforms, ds.xforms[:n], rtol=1e-5, atol=1e-5),
          "[png] the loaded cameras are not the views'")
    lin = load_image(root / "v000.png", as_float_linear=True)
    w0 = want[0].copy()
    w0[..., :3] = np.where(w0[..., :3] <= 0.04045, w0[..., :3] / 12.92,
                           ((w0[..., :3] + 0.055) / 1.055) ** 2.4)
    check(np.array_equal(lin, w0), "[png] load_image(linear) is not sRGB -> linear of the bytes")
    log(f"[png] {n} views {WIDTH}x{HEIGHT} written as 8-bit RGBA PNG in {out['write_s']:.2f} s "
        f"({sum(f.stat().st_size for f in root.glob('*.png')) / 1e6:.1f} MB), decoded on 16 "
        f"threads in {out['decode_s']:.2f} s, loaded by Session.load_file (dataset and "
        f"engine) in {out['load_s']:.2f} s: images equal the views quantised to 8 bits, view "
        f"0 through load_image equals sRGB -> linear of its bytes")
    t = time.perf_counter()
    sess.engine.grid_interval = PNG_STEPS
    loss = sess.train(PNG_STEPS)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t
    out["loss"] = loss
    check(math.isfinite(loss), "[png] non-finite loss")
    t = time.perf_counter()
    pred, gt, err, psnr = sess.compare_view(0, downscale=PNG_COMPARE_DOWNSCALE,
                                            tile=LIVE_BIG_TILE)
    out["compare_s"] = time.perf_counter() - t
    out["compare_psnr_db"] = psnr
    shape = (HEIGHT // PNG_COMPARE_DOWNSCALE, WIDTH // PNG_COMPARE_DOWNSCALE, 3)
    check(pred.shape == gt.shape == err.shape == shape and math.isfinite(psnr),
          "[png] compare_view")
    log(f"[png] {PNG_STEPS} steps through Session.train in {out['train_s']:.1f} s (loss "
        f"{loss:.5f}); compare_view(0, downscale={PNG_COMPARE_DOWNSCALE}) in "
        f"{out['compare_s']:.1f} s: PSNR {psnr:.2f} dB")
    del sess
    torch.cuda.empty_cache()
    return out


# -- the trainer's learners (Slice C2b) ----------------------------------------


def _view_subset(eng, state, n: int, device):
    """`eng` and `state` cut to the first n training views, on `device`
    (the card-vs-CPU steps: the engines' set-up is per view)."""
    import torch

    from sienerf_torch.ops.optim import tree_map

    per_view = ("images", "xforms", "focals", "pp", "xforms_end", "depths")
    dev = torch.device(device)
    data = {k: (v[:n] if k in per_view else v).to(dev) for k, v in eng.data.items()}
    e = dataclasses.replace(eng, images=eng.images[:n], xforms=eng.xforms[:n],
                            focals=eng.focals[:n], principal_points=eng.principal_points[:n],
                            data=data, device=dev,
                            train_n_rays=max(256, TRAIN_CHECK_BATCH // eng.train_k))
    for attr in ("_mean_samples", "_phase"):
        if hasattr(eng, attr):
            setattr(e, attr, getattr(eng, attr))
    params = {k: (v[:n] if k in ("cam", "exposure", "extra_dims") else v)
              for k, v in state["params"].items()}
    st = {"params": params, "occ": state["occ"], "step": state["step"]}
    if "emap" in state:
        st["emap"] = dict(state["emap"], error=state["emap"]["error"][:n])
    return e, tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, st)


def learner_step_check(name: str, eng, state, dev) -> dict:
    """One injected step of `eng` on the card against the CPU, on the first
    TRAIN_CHECK_VIEWS views at TRAIN_CHECK_BATCH samples: the loss at
    STEP_LOSS_RTOL (STEP_FLIP_RTOL with the card's roundings put in), every
    leaf's gradient (the learners' too) within STEP_MAX_SHARE, the MLPs at
    STEP_MLP_TOL."""
    import torch

    from sienerf_torch.ops.optim import tree_map

    t = time.perf_counter()
    ceng, cst = _view_subset(eng, state, TRAIN_CHECK_VIEWS, dev)
    peng, pst = _view_subset(eng, state, TRAIN_CHECK_VIEWS, "cpu")
    n_rays, k, iters = ceng._phase_geometry()
    draws = peng.draw_step(torch.Generator().manual_seed(1), n_rays, int(pst["step"]))
    d_card = tree_map(lambda x: x.to(dev), draws)
    rays = {}  # each device's first (samples a ray, per-ray loss)

    def call(params, device):
        e, st, d = (ceng, cst, d_card) if device.type == "cuda" else (peng, pst, draws)
        loss, grads, aux = e.loss_and_grads(dict(st, params=params), d, k, iters)
        rays.setdefault(device.type, (aux[0].cpu(), aux[1].detach().cpu().double()))
        return loss, grads

    agree = {}

    def report():
        same = float((rays["cuda"][0] == rays["cpu"][0]).float().mean())
        d_ray = (rays["cuda"][1] - rays["cpu"][1]).abs()
        agree.update(same_samples=same, rays_apart=int((d_ray > 1e-6).sum()))
        log(f"[{name}] at {n_rays} rays x k {k} on {TRAIN_CHECK_VIEWS} views "
            f"({time.perf_counter() - t:.1f} s): {100 * same:.2f} % of rays with the same "
            f"samples, {agree['rays_apart']} rays' losses more than 1e-6 apart (largest "
            f"{float(d_ray.max()):.3g})")

    out = card_vs_cpu_step(name, call, pst["params"], dev, loss_rtol=STEP_LOSS_RTOL,
                           mlp_by_name=True, before_checks=report)
    out.update(agree, n_rays=n_rays, k=k, seconds=time.perf_counter() - t)
    return out


def _timed_bundle(name: str, eng, state, dev, steps: int | None = None) -> tuple:
    """One unsynchronised bundle (of `steps` steps, else eng.grid_interval)
    from `state` -> (state, numbers)."""
    import torch

    if steps is not None:
        interval, eng.grid_interval = eng.grid_interval, steps
        try:
            return _timed_bundle(name, eng, state, dev)
        finally:
            eng.grid_interval = interval
    stats = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    st, loss, cnt = eng.train_bundle(state, torch.Generator(device=dev).manual_seed(0), stats)
    loss, cnt = float(loss), float(cnt)
    ms = 1e3 * (time.perf_counter() - t) / eng.grid_interval
    out = {"ms_per_step": ms, "loss": loss, "samples_per_ray": cnt, "n_rays": stats["n_rays"],
           "k": stats["k"], "steps": eng.grid_interval}
    log(f"[{name}] one bundle of {eng.grid_interval} steps at {stats['n_rays']} rays x k "
        f"{stats['k']}: {ms:.1f} ms a step, loss {loss:.5f}, {cnt:.1f} samples a ray")
    check(math.isfinite(loss), f"[{name}] non-finite loss")
    return st, out


def _teacher_depths(sess, xforms, dev):
    """The fox teacher's sweep depth at each training view, as ray distance
    along the unit direction (the trainer's depth), 0 where alpha < 0.5."""
    import numpy as np
    import torch

    from sienerf_torch.engines.nerf_sweep import render_frame_sweep

    grid, meta = sess.bake(resolution=BAKE_RES)
    eng, params = sess.engine, sess.render_params()
    x = (torch.arange(WIDTH, device=dev) + 0.5) / WIDTH - 0.5
    y = (torch.arange(HEIGHT, device=dev) + 0.5) / HEIGHT - 0.5
    yy, xx = torch.meshgrid(y * HEIGHT / FOCAL[1], x * WIDTH / FOCAL[0], indexing="ij")
    dnorm = torch.sqrt(xx * xx + yy * yy + 1.0)
    out = np.empty((len(xforms), HEIGHT, WIDTH), np.float32)
    for i, xf in enumerate(xforms):
        rgba, depth = render_frame_sweep(eng, params, grid, meta, xf, FOCAL, width=WIDTH,
                                         height=HEIGHT)
        out[i] = torch.where(rgba[..., 3] >= 0.5, depth * dnorm, 0.0).cpu().numpy()
    sess._baked = None
    return out


def learners_phase(sess, tr, dev, cuda_ms) -> dict:
    """The trainer's optional learners at the [train] student's full width
    (its engine's views, device copies and visibility mask, through
    dataclasses.replace): engine A (every camera and background learner at
    once), engine B (LEARN_CODES latent codes a view), the lenses and
    motion blur, the two-phase path.  Each engine's injected step against
    the CPU, its timed bundle, its frames through the kernels (counted
    from 0) against plain."""
    import numpy as np
    import torch

    from sienerf_torch import metrics
    from sienerf_torch.common import LensMode
    from sienerf_torch.engines.nerf_sweep import (
        axis_view,
        prepare_rgba_volume,
        sweep_geometry,
    )
    from sienerf_torch.models.nerf_network import NerfNetworkConfig
    from sienerf_torch.ops.optim import inference_params, optim_init, tree_map
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel, sweep_composite_plain
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import Lens, look_at_matrix, pixel_grid_uv, uv_to_ray

    out, launches = {}, {}
    eng0, state0, ds = tr["engine"], tr["state"], tr["dataset"]
    n = ds.n_images
    rng = np.random.default_rng(10)
    cam = look_at_matrix(EYES[0], [0.5, 0.5, 0.5])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    def student(eng, state):
        s = Session(device=dev)
        s.engine, s.state, s.network_config = eng, state, sess.network_config
        return s

    def counted(fn):
        zero_kernel_counts()
        r = fn()
        torch.cuda.synchronize()
        return r, kernel_counts()

    def fresh_state(eng, params):
        return {"params": params, "opt": optim_init(params, eng.opt), "occ": state0["occ"],
                "step": state0["step"], "emap": state0["emap"]}

    part_s = {}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        part_s[name] = time.perf_counter() - t_part
        log(f"[learners] part ({name}) in {part_s[name]:.1f} s")
        t_part = time.perf_counter()

    # -- (a) engine A: cameras, focal, exposure, distortion map, envmap,
    # depth, near-density, rolling shutter, all at once
    t = time.perf_counter()
    depths = _teacher_depths(sess, ds.xforms, dev)
    ang = math.radians(0.4)
    rot = np.asarray([[math.cos(ang), 0, math.sin(ang)], [0, 1, 0],
                      [-math.sin(ang), 0, math.cos(ang)]], np.float32)
    xf_end = ds.xforms.copy()
    xf_end[:, :, :3] = np.einsum("ij,njk->nik", rot, ds.xforms[:, :, :3])
    xf_end[:, :, 3] += np.asarray([0.004, 0.0, -0.002], np.float32)
    engA = dataclasses.replace(
        eng0, optimize_extrinsics=True, optimize_focal=True, optimize_exposure=True,
        optimize_distortion=True, distortion_resolution=LEARN_DIST_RES, train_envmap=True,
        envmap_resolution=LEARN_ENVMAP, depth_supervision_lambda=LEARN_DEPTH_LAMBDA,
        near_density_reg=LEARN_NEAR_REG,
        rolling_shutter=np.asarray(LEARN_ROLLING_SHUTTER, np.float32),
        data=dict(eng0.data, xforms_end=put(xf_end), depths=put(depths)))
    engA._mean_samples = eng0._mean_samples
    del depths
    env = np.concatenate([rng.uniform(0.0, 0.3, LEARN_ENVMAP + (3,)),
                          np.ones(LEARN_ENVMAP + (1,))], axis=-1)
    pA = dict(state0["params"], cam=put(rng.normal(0, 1e-3, (n, 6))),
              focal=put(rng.normal(0, 1e-2, 2)), exposure=put(rng.normal(0, 0.05, (n, 1))),
              distortion=put(rng.normal(0, 1e-3, (LEARN_DIST_RES, LEARN_DIST_RES, 2))),
              envmap=put(env))
    stateA = fresh_state(engA, pA)
    log(f"[learners] engine A: {n} views, cameras, focal, exposure, a {LEARN_DIST_RES}^2 "
        f"distortion map, a {LEARN_ENVMAP[0]}x{LEARN_ENVMAP[1]} envmap, depth (the teacher's, "
        f"{float((engA.data['depths'] > 0).float().mean()):.3f} of pixels), near-density "
        f"{LEARN_NEAR_REG}, rolling shutter {LEARN_ROLLING_SHUTTER}; set up in "
        f"{time.perf_counter() - t:.1f} s")
    out["A_step"] = learner_step_check("learners A", engA, stateA, dev)
    stateA1, out["A_bundle"] = _timed_bundle("learners A", engA, stateA, dev, LEARN_TIMED_STEPS)
    out["A_determinism"] = determinism_check(engA, stateA, dev, tag=" A")
    split, plain = out["A_determinism"]["phase_ms_per_step"], tr.get("phase_ms_per_step") or {}
    log("[learners] engine A's step split (synchronised) beside the plain student's: "
        + ", ".join(f"{k} {v:.2f} / {plain.get(k, float('nan')):.2f} ms" for k, v in split.items()))
    check(out["A_determinism"]["bundles_equal"] and out["A_determinism"]["grads_equal"],
          "[learners] engine A is not deterministic on the card")
    for leaf in ("cam", "focal", "exposure", "distortion", "envmap"):
        check(not torch.equal(stateA1["params"][leaf], pA[leaf]), f"[learners] {leaf} stayed")
    sA = student(engA, stateA1)
    t = time.perf_counter()
    sA.bake(resolution=BAKE_RES)
    torch.cuda.synchronize()
    out["A_bake_s"] = time.perf_counter() - t
    t = time.perf_counter()
    frame, launches["A_sweep"] = counted(
        lambda: sA.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep"))
    out["A_sweep_ms"] = 1e3 * (time.perf_counter() - t)
    check(launches["A_sweep"]["shade"] == 1 and launches["A_sweep"]["sweep"] == 1,
          f"[learners] engine A's sweep frame: launches {launches['A_sweep']}")
    plain_frame = sA.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep", impl="plain")
    out["A_frame_max_abs_err"] = compare("[learners] engine A sweep frame (envmap behind) vs "
                                         "plain", frame, plain_frame, **FRAME_TOL)
    check(float(frame[..., 3].mean()) > 0.05, "[learners] engine A: empty frame")
    del frame, plain_frame, sA
    part("a")

    # -- (b) engine B: LEARN_CODES learnable latent codes a view
    netB = NerfNetworkConfig.from_network_config(sess.network_config, aabb_scale=ds.aabb_scale,
                                                 n_extra_dims=LEARN_CODES)
    check(netB.rgb_mlp.n_input_dims == 16 + LEARN_CODES + 16, "[learners] colour MLP width")
    engB = dataclasses.replace(eng0, net=netB, optimize_extra_dims=True)
    engB._mean_samples = eng0._mean_samples
    w0 = state0["params"]["rgb_mlp"][0]
    pB = dict(state0["params"], extra_dims=put(rng.uniform(-1, 1, (n, LEARN_CODES))),
              rgb_mlp=[torch.cat([w0[:16], put(rng.normal(0, 0.1, (LEARN_CODES, w0.shape[1]))),
                                  w0[16:]])] + list(state0["params"]["rgb_mlp"][1:]))
    stateB = fresh_state(engB, pB)
    out["B_step"] = learner_step_check("learners B", engB, stateB, dev)
    stateB1, out["B_bundle"] = _timed_bundle("learners B", engB, stateB, dev, LEARN_TIMED_STEPS)
    check(not torch.equal(stateB1["params"]["extra_dims"], pB["extra_dims"]),
          "[learners] the latent codes stayed")
    sB = student(engB, stateB1)
    t = time.perf_counter()
    grid, meta = sB.bake(resolution=BAKE_RES)
    torch.cuda.synchronize()
    out["B_bake_s"] = time.perf_counter() - t
    t = time.perf_counter()
    frame, launches["B_sweep"] = counted(
        lambda: sB.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep"))
    out["B_sweep_ms"] = 1e3 * (time.perf_counter() - t)
    check(launches["B_sweep"]["shade"] == 0 and launches["B_sweep"]["sweep"] == 1,
          f"[learners] engine B's sweep frame: the plain shade and K2 only, launches "
          f"{launches['B_sweep']}")
    plain_frame = sB.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep", impl="plain")
    out["B_frame_max_abs_err"] = compare("[learners] engine B sweep frame vs plain", frame,
                                         plain_frame, **FRAME_TOL)
    check(float(frame[..., 3].mean()) > 0.05, "[learners] engine B: empty frame")
    # K2 on the plain shade's volume against its plain version
    params = sB.render_params()
    g = sweep_geometry(engB, cam, FOCAL, width=WIDTH, height=HEIGHT, device=dev)
    R, K = meta["resolution"], meta["n_cascades"]
    vol = prepare_rgba_volume(engB, params, grid["rows"], grid["scale"], g["o"][0], R,
                              K).permute(0, 1, 4, 2, 3)
    near, min_t = max(0.05, engB.near_distance), engB.render_min_transmittance
    args = (axis_view(vol, g["axis"]), g["o_c"], g["eb"], g["ec"], near, min_t)
    kw = dict(resolution=R, n_cascades=K, data_flip=g["flip"])
    got = sweep_composite_kernel(*args, **kw)
    want = sweep_composite_plain(*args, **kw)
    out["B_k2_max_abs_err"] = max(compare(f"[learners] K2 {nm} on engine B's volume", a,
                                          b.contiguous(), **K2_TOL)
                                  for nm, a, b in zip(("C", "opacity", "T", "depth_t"), got, want))
    out["B_k2_ms"] = cuda_ms(lambda: sweep_composite_kernel(*args, **kw), 10)
    del vol, args, got, want, frame, plain_frame
    # the baked frames through G2, view 0's code and then view 3's, at
    # 320x180 to keep the script inside its limit
    bw, bh = FINE_FRAME
    bfocal = tuple(f * bw / WIDTH for f in FOCAL)
    frames = {}
    for view in (0, 3):
        sB.rendering_extra_dims_from_training_view = view
        t = time.perf_counter()
        frames[view], launches[f"B_baked_view{view}"] = counted(
            lambda: sB.render(bw, bh, cam, bfocal, renderer="baked"))
        out[f"B_baked_view{view}_ms"] = 1e3 * (time.perf_counter() - t)
        n_g2 = launches[f"B_baked_view{view}"]["gather_small"]
        check(n_g2 > 0 and launches[f"B_baked_view{view}"]["shade"] == 0,
              f"[learners] engine B's baked frame: launches {launches[f'B_baked_view{view}']}")
        log(f"[learners] engine B baked frame {bw}x{bh}, view {view}'s code: "
            f"{out[f'B_baked_view{view}_ms']:.1f} ms, {n_g2} G2 launches")
    # the frame of another view's code against the plain gathers
    plain_frame = sB.render(bw, bh, cam, bfocal, renderer="baked", impl="plain")
    check(torch.equal(frames[3], plain_frame),
          "[learners] engine B's baked frame (view 3's code) differs from plain")
    log("[learners] engine B's view-3 baked frame equals the plain frame (tolerance 0)")
    check(not torch.equal(frames[0], frames[3]), "[learners] another view's code changed nothing")
    out["B_baked_views_psnr_db"] = float(metrics.psnr(frames[0][..., :3], frames[3][..., :3]))
    sB.rendering_extra_dims_from_training_view = 0
    del frames, plain_frame
    # a small live frame against the CPU
    sw, sh = LEARN_SMALL
    focal_s = tuple(f * sw / WIDTH for f in FOCAL)
    card = sB.render(sw, sh, cam, focal_s, renderer="live")
    cpu = Session(device="cpu")
    cpu.engine = dataclasses.replace(engB, device=torch.device("cpu"))
    cpu.state = {"params": tree_map(lambda x: x.cpu(), params),
                 "occ": {"bitfield": stateB1["occ"]["bitfield"].cpu()}}
    t = time.perf_counter()
    on_host = cpu.render(sw, sh, cam, focal_s, renderer="live")
    out["B_live_cpu_s"] = time.perf_counter() - t
    out["B_live_cpu_agree"] = frame_agreement(f"[learners] engine B live {sw}x{sh} card vs CPU",
                                              card.cpu(), on_host)
    check(out["B_live_cpu_agree"] >= LIVE_MIN_AGREE, "[learners] engine B's live frame")
    del sB, grid, meta, cpu, params
    part("b")

    # -- (c) lenses, distortion, motion blur
    uv = pixel_grid_uv(WIDTH, HEIGHT, dev).reshape(-1, 2)
    out["lens_ray_max_abs_err"] = {}
    for mode, lp in LENS_PARAMS.items():
        lens = Lens(LensMode(mode), lp)
        o, d = uv_to_ray(uv, (WIDTH, HEIGHT), FOCAL, cam, (0.5, 0.5), lens)
        oc, dc = uv_to_ray(uv.cpu(), (WIDTH, HEIGHT), FOCAL, cam, (0.5, 0.5), lens)
        out["lens_ray_max_abs_err"][mode] = compare(  # compared a pixel row at a time
            f"[learners] {mode} rays card vs CPU", d.cpu().reshape(HEIGHT, WIDTH, 3),
            dc.reshape(HEIGHT, WIDTH, 3), **RAY_TOL)
    ema = inference_params(state0["opt"], state0["params"])
    engL = dataclasses.replace(eng0, lens=Lens(LensMode.OPENCV, LENS_PARAMS["opencv"]))
    torch.cuda.synchronize()
    t = time.perf_counter()
    lw, lh = FINE_FRAME  # cut from 1280x720 to keep the script inside its limit
    lf = engL.render_frame(ema, state0["occ"]["bitfield"], lw, lh, cam,
                           tuple(f * lw / WIDTH for f in FOCAL), tile=LIVE_BIG_TILE)[0]
    torch.cuda.synchronize()
    out["opencv_live_ms"] = 1e3 * (time.perf_counter() - t)
    check(bool(torch.isfinite(lf).all()) and float(lf[..., 3].mean()) > 0.05,
          "[learners] the OpenCV-lens live frame is empty")
    log(f"[learners] {lw}x{lh} live frame through the OpenCV lens: "
        f"{out['opencv_live_ms']:.1f} ms (tile 2^17), mean alpha {float(lf[..., 3].mean()):.3f}")
    pA1 = stateA1["params"]
    dist_card = engA.render_frame(pA1, stateA1["occ"]["bitfield"], WIDTH, HEIGHT, cam, FOCAL,
                                  render_mode="distortion")[0]
    dist_cpu = dataclasses.replace(engA, device=torch.device("cpu")).render_frame(
        {"distortion": pA1["distortion"].cpu()}, stateA1["occ"]["bitfield"].cpu(), WIDTH,
        HEIGHT, cam, FOCAL, render_mode="distortion")[0]
    out["distortion_frame_max_abs_err"] = compare(
        "[learners] distortion-mode frame card vs CPU", dist_card.cpu(), dist_cpu,
        rtol=1e-4, atol=1e-4)
    check(float(dist_card[..., :3].max()) > 0.0, "[learners] the distortion frame is black")
    del lf, dist_card, dist_cpu
    sw, sh = MOTION_SMALL
    focal_s = tuple(f * sw / WIDTH for f in FOCAL)
    end = look_at_matrix([2.0, 0.65, 0.75], [0.5, 0.5, 0.5])
    sM = student(eng0, state0)
    card = sM.render(sw, sh, cam, focal_s, spp=MOTION_SPP, camera_matrix_end=end)
    cpu = Session(device="cpu")
    cpu.engine = dataclasses.replace(eng0, device=torch.device("cpu"))
    cpu.state = {"params": tree_map(lambda x: x.cpu(), ema),
                 "occ": {"bitfield": state0["occ"]["bitfield"].cpu()}}
    t = time.perf_counter()
    on_host = cpu.render(sw, sh, cam, focal_s, spp=MOTION_SPP, camera_matrix_end=end)
    out["motion_cpu_s"] = time.perf_counter() - t
    out["motion_cpu_agree"] = frame_agreement(
        f"[learners] motion-blurred {sw}x{sh} spp {MOTION_SPP} card vs CPU", card.cpu(), on_host)
    check(out["motion_cpu_agree"] >= LIVE_MIN_AGREE, "[learners] the motion-blurred frame")
    still = sM.render(sw, sh, cam, focal_s, spp=MOTION_SPP)
    check(float((still - card).abs().max()) > 1e-2, "[learners] the blur moved nothing")
    del cpu, sM, ema
    part("c")

    # -- (d) the legacy two-phase path: a deep bundle, the switch, a fast step
    engD = dataclasses.replace(eng0, compact_training=False)
    engD._phase = "deep"
    out["D_step"] = learner_step_check("learners D (deep)", engD, state0, dev)
    stateD, out["D_bundle"] = _timed_bundle("learners D (deep)", engD, state0, dev,
                                            LEARN_TIMED_STEPS)
    mean = out["D_bundle"]["samples_per_ray"]
    out["D_phase_after"] = getattr(engD, "_phase", "deep")
    check((out["D_phase_after"] == "fast") == (mean < engD.phase_switch_count * engD.deep_k),
          f"[learners] the deep phase's switch: {out['D_phase_after']} at {mean:.1f} samples")
    n_rays, k, iters = engD._phase_geometry()
    draws = engD.draw_step(torch.Generator(device=dev).manual_seed(3), n_rays,
                           int(stateD["step"]))
    t = time.perf_counter()
    _, loss, _ = engD.train_step(stateD, draws, k, iters)
    out["D_next_step"] = {"phase": out["D_phase_after"], "n_rays": n_rays, "k": k,
                          "loss": float(loss), "ms": 1e3 * (time.perf_counter() - t)}
    check(math.isfinite(float(loss)), "[learners] the step after the deep bundle")
    log(f"[learners] two-phase: after the deep bundle ({mean:.1f} samples a ray at k "
        f"{engD.deep_k}) the phase is {out['D_phase_after']}; its next step at {n_rays} rays x "
        f"k {k}: loss {float(loss):.5f}, {out['D_next_step']['ms']:.1f} ms")
    del engA, engB, engD, stateA, stateA1, stateB, stateB1, stateD, pA, pB
    part("d")
    out["part_s"] = part_s
    out["launches"] = launches
    out["launches_by_kernel"] = {k: sum(c[k] for c in launches.values())
                                 for k in ("shade", "sweep", "gather_rows", "gather_small")}
    log(f"[learners] kernel launches on the learner paths: {launches}")
    return out


# -- the corner table layout and the front-ends (Slice G) ---------------------


def corner_phase(tr, dev, cuda_ms) -> dict:
    """A corner-layout copy of configs/nerf/base.json at full width (16
    levels x 2 features, 2^19 vertex rows) on the [train] phase's views: a
    4-step warm bundle, one timed bundle of CORNER_TIMED_STEPS steps at TRAIN_BATCH beside
    the cell student's ms a step, the hash encode's forward and backward
    at TRAIN_BATCH samples, one card step against the CPU (every leaf), two
    bundles from one seed bit-equal; then the field exported with
    export_ingp, reloaded by Session.load_snapshot (its fp16 table), trained
    4 steps on the card, baked at CORNER_BAKE_RES and rendered as a 720p
    sweep frame through K1 and K2 against the plain frame."""
    import numpy as np
    import torch

    from sienerf_torch.engines.nerf import NerfEngine
    from sienerf_torch.io.ingp import export_ingp, tcnn_grid_level_sizes
    from sienerf_torch.ops import hashgrid
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix
    from sienerf_torch.utils.config import load_network_config

    out = {}
    cfg = load_network_config(ROOT / "configs" / "nerf" / "base.json")
    cfg["encoding"] = dict(cfg["encoding"], layout="corner")
    ds = tr["dataset"]
    t = time.perf_counter()
    eng = NerfEngine.create(cfg, ds, train_batch_size=TRAIN_BATCH, device=dev)
    g = eng.net.grid
    check(g.layout == "corner" and (g.n_levels, g.n_features_per_level,
                                    g.log2_hashmap_size) == (16, 2, 19),
          "[corner] the config is not base.json's grid in the corner layout")
    state = eng.init(0)
    check(tuple(state["params"]["grid"].shape) == (16, 1 << 19, 2),
          "[corner] the table is not (L, T, F)")
    eng.grid_interval = 4
    state, _, _ = eng.train_bundle(state, torch.Generator(device=dev).manual_seed(0))
    eng.grid_interval = 16
    state, out["bundle"] = _timed_bundle("corner", eng, state, dev, CORNER_TIMED_STEPS)
    out["ms_per_step"] = out["bundle"]["ms_per_step"]
    out["cell_ms_per_step"] = tr["ms_per_step"]
    log(f"[corner] 16x2 corner-layout field, 2^19 rows, aabb {ds.aabb_scale}: "
        f"{out['ms_per_step']:.1f} ms a step against the cell student's (8x4) "
        f"{tr['ms_per_step']:.1f} ms (create, init and warm bundle "
        f"{time.perf_counter() - t:.1f} s)")
    # the hash grid alone at the batch size, as [train] times the cell table
    gen = torch.Generator(device=dev).manual_seed(3)
    pos = torch.rand((TRAIN_BATCH, 3), generator=gen, device=dev)
    table = state["params"]["grid"].detach().requires_grad_(True)
    gout = torch.randn((TRAIN_BATCH, g.n_output_dims), generator=gen, device=dev)
    fwd_ms = cuda_ms(lambda: hashgrid.hashgrid_encode(g, table, pos), 5)
    both_ms = cuda_ms(lambda: torch.autograd.grad(hashgrid.hashgrid_encode(g, table, pos),
                                                  table, gout), 5)
    out["hash_fwd_ms"], out["hash_bwd_ms"] = fwd_ms, both_ms - fwd_ms
    log(f"[corner] hash grid at {TRAIN_BATCH} samples: forward {fwd_ms:.3f} ms, backward "
        f"{both_ms - fwd_ms:.3f} ms ({TRAIN_BATCH * g.n_levels * 8} contributions sorted "
        f"once); the cell student's {tr['hash_fwd_ms']:.3f} / {tr['hash_bwd_ms']:.3f} ms")
    del pos, table, gout
    out["card_vs_cpu"] = learner_step_check("corner", eng, state, dev)
    out["determinism"] = determinism_check(eng, state, dev, tag=" corner")

    # export as .ingp, reload through the Session, train on, serve
    path = Path(tempfile.mkdtemp()) / "corner.ingp"
    export_ingp(path, cfg, state["params"], g, eng.net.density_mlp, eng.net.rgb_mlp,
                density_grid=state["occ"]["density"].cpu().numpy(),
                aabb_scale=float(ds.aabb_scale), training_step=int(state["step"]))
    s = Session(device=dev)
    s.dataset = ds  # train the imported field on the same views
    t = time.perf_counter()
    s.load_snapshot(path)
    out["ingp_mb"] = path.stat().st_size / 1e6
    got = s.state["params"]["grid"]
    check(s.engine.net.grid.layout == "corner" and s.training_step == int(state["step"]),
          "[corner] the .ingp did not load as a corner field at its step")
    want = state["params"]["grid"].half().float()
    for lv, n in enumerate(tcnn_grid_level_sizes(g)):  # the rows tcnn stores a level
        check(torch.equal(got[lv, :n], want[lv, :n]) and not bool(got[lv, n:].any()),
              f"[corner] level {lv} of the reloaded table is not the exported one in fp16")
    table0 = got.clone()
    s.engine.grid_interval = 2  # a few steps show that it trains
    loss = s.train(2)
    torch.cuda.synchronize()
    out["ingp_train_s"] = time.perf_counter() - t
    out["ingp_loss"] = loss
    check(math.isfinite(loss) and not torch.equal(s.state["params"]["grid"], table0),
          "[corner] the reloaded field did not train")
    log(f"[corner] exported ({out['ingp_mb']:.1f} MB .ingp), reloaded by "
        f"Session.load_snapshot and trained 2 steps in {out['ingp_train_s']:.1f} s: loss "
        f"{loss:.5f}")
    cam = look_at_matrix(EYES[0], [0.5, 0.5, 0.5])
    zero_kernel_counts()
    t = time.perf_counter()
    frame = s.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep",
                     bake_resolution=CORNER_BAKE_RES)
    torch.cuda.synchronize()
    out["bake_and_frame_s"] = time.perf_counter() - t
    out["launches"] = kernel_counts()
    plain = s.render(WIDTH, HEIGHT, cam, FOCAL, renderer="sweep", impl="plain")
    agree = frame_agreement("[corner] 720p sweep frame vs plain (K1 and K2 plain)", frame, plain)
    out["frame_vs_plain_agree"] = agree
    log(f"[corner] bake R={CORNER_BAKE_RES} and a 720p sweep frame in "
        f"{out['bake_and_frame_s']:.1f} s, launches {out['launches']}, mean alpha "
        f"{float(frame[..., 3].mean()):.3f}")
    check(agree >= 1.0 - 1e-4, "[corner] the sweep frame differs from the plain frame")
    check(out["launches"]["shade"] >= 1 and out["launches"]["sweep"] >= 1,
          "[corner] K1 or K2 was not launched by the imported field's frame")
    del s, eng, state, frame, plain
    torch.cuda.empty_cache()
    return out


def frontends_phase(sess, dev, png_root: Path, png_net: Path, tmp: Path) -> dict:
    """The front-ends on the fox session: viewer.orbit_benchmark through the
    sweep, render_view foveated (live, and baked through G2) against the
    CPU, viewer.serve on 127.0.0.1 port 0 answering a frame, a Testbed
    screenshot, and the CLI twin sienerf_torch.run.main on the [png]
    phase's scene.  K1, K2 and G2 must launch on these paths."""
    import threading
    import urllib.request

    import numpy as np
    import torch

    from sienerf_torch import pyngp_compat, viewer
    from sienerf_torch import run as cli
    from sienerf_torch.io.png import read_png
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    out = {}
    if sess._baked is None:
        sess.bake(resolution=BAKE_RES)
    zero_kernel_counts()
    t = time.perf_counter()
    rows = viewer.orbit_benchmark(sess, n_frames=FRONT_ORBIT_FRAMES, width=640, height=360,
                                  renderer="sweep")
    out["orbit_s"] = time.perf_counter() - t
    out["orbit"] = rows
    ms = [r["ms"] for r in rows]
    log(f"[frontends] orbit_benchmark {FRONT_ORBIT_FRAMES} sweep frames at 640x360: rungs "
        f"{[r['rung'] for r in rows]}, sizes {sorted({(r['w'], r['h']) for r in rows})}, ms "
        f"{ms} (median {statistics.median(ms):.1f} ms)")
    check(len(rows) == FRONT_ORBIT_FRAMES and all(math.isfinite(m) for m in ms),
          "[frontends] orbit_benchmark log")

    # foveated views: card at 320x180, and card vs CPU at 80x45
    cpu_sess = Session(device="cpu")
    cpu_sess.load_snapshot(SNAP)
    cpu_sess._baked = ({k: v.cpu() for k, v in sess._baked[0].items()}, dict(sess._baked[1]))
    cam = look_at_matrix(EYES[0], [0.5, 0.5, 0.5])
    out["foveated"] = {}
    for renderer in ("live", "baked"):
        kw = dict(foveation_density=FRONT_FOVEATION, renderer=renderer)
        t = time.perf_counter()
        big = viewer.render_view(sess, cam, *FRONT_FOVEATED,
                                 focal=tuple(f * FRONT_FOVEATED[0] / WIDTH for f in FOCAL), **kw)
        torch.cuda.synchronize()
        big_ms = 1e3 * (time.perf_counter() - t)
        check(big.shape == (FRONT_FOVEATED[1], FRONT_FOVEATED[0], 4)
              and bool(torch.isfinite(big).all()) and float(big[..., 3].mean()) > 0.05,
              f"[frontends] foveated {renderer} view")
        cw, ch = CPU_SMALL
        focal = tuple(f * cw / WIDTH for f in FOCAL)
        card = viewer.render_view(sess, cam, cw, ch, focal=focal, **kw).cpu()
        t = time.perf_counter()
        on_cpu = viewer.render_view(cpu_sess, cam, cw, ch, focal=focal, **kw)
        cpu_s = time.perf_counter() - t
        agree = frame_agreement(f"[frontends] foveated {renderer} {cw}x{ch} card vs CPU",
                                card, on_cpu)
        out["foveated"][renderer] = {"ms": big_ms, "cpu_agree": agree, "cpu_s": cpu_s}
        log(f"[frontends] foveated {renderer} view (density {FRONT_FOVEATION}) "
            f"{FRONT_FOVEATED[0]}x{FRONT_FOVEATED[1]} in {big_ms:.1f} ms; {cw}x{ch} against "
            f"the CPU ({cpu_s:.1f} s there): {100 * agree:.2f} % of pixels agree")
        check(agree >= LIVE_MIN_AGREE, f"[frontends] foveated {renderer}: card and CPU "
                                       f"disagree")
    del cpu_sess

    # the HTTP viewer on port 0, one frame through the sweep
    srv = viewer.make_server(sess, "127.0.0.1", 0, width=640, height=360, target_ms=1e9,
                             renderer="sweep")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            check(r.status == 200 and b"<canvas" in r.read(), "[frontends] the viewer page")
        t = time.perf_counter()
        with urllib.request.urlopen(f"{base}/frame?theta=0.9&phi=0.2&r=2.0", timeout=300) as r:
            served_ms = r.headers["x-render-ms"]
            (tmp / "served.png").write_bytes(r.read())
        out["serve_fetch_ms"] = 1e3 * (time.perf_counter() - t)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    got = read_png(tmp / "served.png")
    frame = viewer.render_view(sess, viewer.orbit_camera((0.5, 0.5, 0.5), 2.0, 0.9, 0.2),
                               640, 352, renderer="sweep")
    want = (np.clip(frame[..., :3].cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    check(got.shape == want.shape, f"[frontends] served frame {got.shape}, want {want.shape}")
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    out["serve_equal_share"] = float((diff == 0).all(axis=-1).mean())
    log(f"[frontends] serve on port {srv.server_address[1]}: /frame 640x352 rendered in "
        f"{served_ms} ms, fetched in {out['serve_fetch_ms']:.1f} ms; its PNG against "
        f"render_view's frame: {100 * out['serve_equal_share']:.3f} % of pixels equal, max "
        f"diff {int(diff.max())}")
    check(out["serve_equal_share"] >= 0.999 and int(diff.max()) <= 1,
          "[frontends] the served frame is not render_view's")

    # a Testbed screenshot of the fox
    tb = pyngp_compat.Testbed(device=dev)
    tb.load_snapshot(SNAP)
    t = time.perf_counter()
    tb.screenshot(str(tmp / "testbed.png"), 320, 180)
    out["testbed_s"] = time.perf_counter() - t
    shot = read_png(tmp / "testbed.png")
    check(shot.shape == (180, 320, 4) and shot[..., 3].mean() > 5,
          "[frontends] Testbed screenshot")
    log(f"[frontends] Testbed screenshot 320x180 in {out['testbed_s']:.2f} s, mean alpha "
        f"{shot[..., 3].mean() / 255:.3f}")
    del tb

    # the CLI twin on the [png] phase's scene
    video = []
    try:
        import cv2  # noqa: F401
        video = ["--video_camera_path", "orbit", "--video_output", str(tmp / "orbit.mp4"),
                 "--video_fps", str(FRONT_CLI_VIDEO_FRAMES), "--video_n_seconds", "1",
                 "--video_spp", "1",
                 "--video_w", "320", "--video_h", "180"]
    except ImportError:
        log("[frontends] no OpenCV here: the CLI run writes no video")
    # the [png] net with its table cut to 2^FRONT_CLI_LOG2_ROWS rows: the CLI
    # saves its snapshot at zlib level 6, as the reference does, ~80 s for
    # the fox-width 2 GB state on the card machine's host (~10 s at 2^16)
    cli_net = json.loads(png_net.read_text())
    cli_net["encoding"] = dict(cli_net["encoding"], log2_hashmap_size=FRONT_CLI_LOG2_ROWS)
    (tmp / "cli_net.json").write_text(json.dumps(cli_net))
    args = ["--scene", str(png_root), "--network", str(tmp / "cli_net.json"), "--device", str(dev),
            "--n_steps", "16", "--batch_size", "65536", "--save_snapshot",
            str(tmp / "cli.msgpack"), "--test_transforms", str(png_root / "transforms.json"),
            "--eval_max_views", str(FRONT_CLI_EVAL_VIEWS), "--eval_spp", "1",
            "--eval_downscale", "4",
            "--renderer", "baked", "--screenshot", str(tmp / "cli.png"),
            "--screenshot_w", "320", "--screenshot_h", "180"] + video
    t = time.perf_counter()
    rc = cli.main(args)
    torch.cuda.synchronize()
    out["cli_s"] = time.perf_counter() - t
    check(rc == 0 and (tmp / "cli.msgpack").stat().st_size > 0
          and read_png(tmp / "cli.png").shape == (180, 320, 4),
          "[frontends] the CLI run's snapshot or screenshot")
    if video:
        import cv2

        cap = cv2.VideoCapture(str(tmp / "orbit.mp4"))
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        check(n == FRONT_CLI_VIDEO_FRAMES,
              f"[frontends] the CLI's video has {n} frames, not {FRONT_CLI_VIDEO_FRAMES}")
    log(f"[frontends] python -m sienerf_torch.run {' '.join(args[6:])}: {out['cli_s']:.1f} s")
    out["launches"] = kernel_counts()
    log(f"[frontends] launches on the front-ends' paths: {out['launches']}")
    for name in ("shade", "sweep", "gather_small"):
        check(out["launches"][name] >= 1, f"[frontends] {name} was never launched")
    return out


def _int_sum(t) -> int:
    """A tensor's bits summed as int32 words (bf16 / bool widened): one
    number a leaf that moves with any bit."""
    import torch

    if t.dtype in (torch.bool, torch.uint8, torch.int16, torch.bfloat16):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return int(t.to(torch.int64).sum())
    return int(t.contiguous().view(torch.int32).to(torch.int64).sum())


def _tree_sums(tree) -> list:
    import torch

    from sienerf_torch.ops.optim import tree_leaves

    return [_int_sum(x) for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _multi_rank(mesh, cfg):
    """One rank of [multi] (parallel/mesh.py::run_ranks): the fox's R=256
    bake, the sharded sweep, live and baked frames of view 0 (the main
    path, counts from 0 before it and read after it), held to the one-device
    frames on rank 0; K1 on this rank's plane range and K2 on its schedule
    range against their plain versions; the sharded trainer on the
    [multi] PNG scene: a step against the one-process mean of the
    per-shard gradients (rank 0), a timed bundle beside a one-rank bundle,
    the replicas' bit sums, two 2-step bundles from one seed."""
    import dataclasses as dc

    import torch
    import torch.distributed as dist

    from sienerf_torch.engines.nerf_baked import render_frame_baked, render_frame_baked_multichip
    from sienerf_torch.engines.nerf_sweep import (
        axis_view,
        render_frame_sweep,
        render_frame_sweep_multichip,
        sweep_geometry,
    )
    from sienerf_torch.models.nerf_network import nerf_l2_mask
    from sienerf_torch.ops.importance import splat_errors
    from sienerf_torch.ops.optim import optim_step, tree_leaves, tree_unflatten
    from sienerf_torch.ops.shade import shade_volume, shade_volume_plain
    from sienerf_torch.ops.sweep_kernel import sweep_composite_kernel, sweep_composite_plain
    from sienerf_torch.parallel.mesh import (
        all_gather,
        all_mean,
        ordered_mean,
        ordered_sum,
        rank_generator,
        replicate,
        shard_range,
    )
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, rank, world = mesh.device, mesh.rank, mesh.world
    lead = rank == 0
    out = {"rank": rank, "device": f"{dev} ({torch.cuda.get_device_name(dev)})"}

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier()

    def timed(fn, reps=1):
        """ms of fn() on every rank together: synchronised and a barrier on
        both sides; the median of `reps`."""
        return statistics.median(timed_call(fn)[0] for _ in range(reps))

    def timed_call(fn):
        sync()
        t = time.perf_counter()
        res = fn()
        sync()
        return 1e3 * (time.perf_counter() - t), res

    sess = Session(device=dev)
    sess.load_snapshot(SNAP)
    t = time.perf_counter()
    grid, meta = sess.bake(resolution=BAKE_RES)
    torch.cuda.synchronize(dev)
    out["bake_s"] = time.perf_counter() - t
    eng, p, bf = sess.engine, sess.render_params(), sess.state["occ"]["bitfield"]
    R, K = meta["resolution"], meta["n_cascades"]
    Rv = R + 1
    rows, scale = grid["rows"], grid["scale"]
    cam = look_at_matrix(EYES[0], [0.5, 0.5, 0.5])
    sw, sh = MULTI_SMALL
    focal_s = tuple(f * sw / WIDTH for f in FOCAL)
    baked_kw = dict(width=sw, height=sh, resolution=R, mode=meta["mode"], n_cascades=K)

    def sweep_sh(min_t=None):
        return render_frame_sweep_multichip(eng, p, grid, meta, cam, FOCAL, mesh, width=WIDTH,
                                            height=HEIGHT, min_transmittance=min_t)

    def live_sh():
        return eng.render_frame_multichip(p, bf, sw, sh, cam, focal_s, mesh,
                                          tile=MULTI_LIVE_TILE)

    def baked_sh():
        return render_frame_baked_multichip(eng, p, bf, grid, cam, focal_s, mesh, **baked_kw)

    # -- the main path, counts from 0, each frame timed
    sync()
    zero_kernel_counts()
    out["sweep_min_t0_ms"], sweep0 = timed_call(lambda: sweep_sh(0.0))
    out["live_ms"], live = timed_call(live_sh)
    out["baked_ms"], baked = timed_call(baked_sh)
    out["launches"] = kernel_counts()
    for name in ("shade", "sweep", "gather_small"):
        check(out["launches"][name] >= 1, f"[multi] rank {rank}: kernel {name} was never "
                                          f"launched on the sharded paths")
    sums = torch.tensor([_int_sum(x) for x in (sweep0[0], live[0], baked[0])], device=dev)
    check(all(torch.equal(g, sums) for g in all_gather(sums, mesh)),
          "[multi] the sharded frames differ between ranks")

    # -- against the one-device frames (rank 0; the others wait)
    if lead:
        one = render_frame_sweep(eng, p, grid, meta, cam, FOCAL, width=WIDTH, height=HEIGHT,
                                 min_transmittance=0.0)
        out["sweep_err"] = compare(f"[multi] sharded {WIDTH}x{HEIGHT} sweep (min "
                                   f"transmittance 0) vs one device", sweep0[0], one[0],
                                   **MULTI_SWEEP_TOL)
        out["sweep_depth_err"] = compare("[multi] its depth", sweep0[1], one[1],
                                         **MULTI_DEPTH_TOL)
        check(float(sweep0[0][..., 3].mean()) > 0.05, "[multi] empty sweep frame")
        one_live = eng.render_frame(p, bf, sw, sh, cam, focal_s)[0]
        out["live_agree"] = frame_agreement(f"[multi] sharded {sw}x{sh} live vs render_frame",
                                            live[0], one_live)
        check(out["live_agree"] >= LIVE_MIN_AGREE, "[multi] the sharded live frame")
        one_baked = render_frame_baked(eng, p, bf, grid, cam, focal_s, **baked_kw)[0]
        out["baked_agree"] = frame_agreement(f"[multi] sharded {sw}x{sh} baked vs "
                                             f"render_frame_baked", baked[0], one_baked)
        check(out["baked_agree"] >= LIVE_MIN_AGREE, "[multi] the sharded baked frame")
        check(float(live[0][..., 3].mean()) > 0.05 and float(baked[0][..., 3].mean()) > 0.05,
              "[multi] empty live or baked frame")
        del one, one_live, one_baked
    sync()

    # -- K1 on this rank's plane range, K2 on its schedule range (with bw)
    acts = dict(density_act=eng.net.density_activation, rgb_act=eng.net.rgb_activation)
    g0 = sweep_geometry(eng, cam, FOCAL, width=WIDTH, height=HEIGHT, device=dev)
    p0, p1 = shard_range(K * Rv, world, rank)
    part = shade_volume(rows, scale, g0["o"][0], p["rgb_mlp"], resolution=R, n_cascades=K,
                        planes=(p0, p1), **acts)
    whole = shade_volume(rows, scale, g0["o"][0], p["rgb_mlp"], resolution=R, n_cascades=K,
                         **acts)
    torch.cuda.synchronize(dev)
    storage = whole.permute(0, 1, 3, 4, 2).reshape(K * Rv, Rv, Rv, 4)
    check(torch.equal(part.permute(0, 2, 3, 1).contiguous().view(torch.int16),
                      storage[p0:p1].contiguous().view(torch.int16)),
          f"[multi] rank {rank}: K1 on planes [{p0}, {p1}) differs from the whole bake's")
    out["k1_err"] = compare(f"[multi] rank {rank} K1 planes [{p0}, {p1}) vs plain", part,
                            shade_volume_plain(rows, scale, g0["o"][0], p["rgb_mlp"],
                                               resolution=R, n_cascades=K, planes=(p0, p1),
                                               **acts), **K1_TOL)
    s0, s1 = shard_range(K * R, world, rank)
    args = (axis_view(whole, g0["axis"]), g0["o_c"], g0["eb"], g0["ec"],
            max(0.05, eng.near_distance), eng.render_min_transmittance)
    kw = dict(resolution=R, n_cascades=K, data_flip=g0["flip"], schedule=(s0, s1),
              return_bw=True)
    got = sweep_composite_kernel(*args, **kw)
    torch.cuda.synchronize(dev)
    want = sweep_composite_plain(*args, **kw)
    out["k2_err"] = max(compare(f"[multi] rank {rank} K2 schedule [{s0}, {s1}) {name} vs plain",
                                a, b.contiguous(), **K2_TOL)
                        for name, a, b in zip(("C", "opacity", "T", "depth_t", "bw"), got, want))
    del part, whole, storage, args, got, want

    # -- the sweep frame at the default min transmittance, every rank together
    out["sweep_ms"] = timed(sweep_sh)
    out["sweep_one_ms"] = timed(lambda: lead and render_frame_sweep(
        eng, p, grid, meta, cam, FOCAL, width=WIDTH, height=HEIGHT), reps=3)
    del sess, grid, rows, scale, p, bf, sweep0, live, baked
    torch.cuda.empty_cache()

    # -- the trainer at the engine's 2^18-sample batch, as the JAX package
    # shards it: a step's rays split over the ranks (n_rays / world each),
    # each rank packing its rays' samples into its own batch, so the ranks
    # together take the one-rank bundle's rays and samples
    tsess = Session(device=dev)
    tsess.load_file(cfg["scene"], network=cfg["net"], train_batch_size=TRAIN_BATCH)
    teng, st = tsess.engine, tsess.state
    replicate(st, mesh)
    n_rays, k, iters = teng._phase_geometry()
    n_local = max(64, n_rays // world)
    # every rank's draws, as each rank draws them: its generator folded
    # from one seeded generator
    draws = [teng.draw_step(rank_generator(torch.Generator(device=dev).manual_seed(11),
                                           dc.replace(mesh, rank=r)), n_local, st["step"])
             for r in range(world)]
    new, loss, cnt = teng.train_step(st, draws[rank], k, iters, mesh=mesh)
    torch.cuda.synchronize(dev)
    if lead:
        per = [teng.loss_and_grads(st, d, k, iters) for d in draws]
        mean = tree_unflatten(st["params"], [ordered_mean(list(g)) for g in zip(
            *[tree_leaves(gr) for _, gr, _ in per])])
        params, _ = optim_step(teng.opt, st["opt"], st["params"], mean,
                               nerf_l2_mask(st["params"]), None)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(new["params"]),
                                                      tree_leaves(params)))
        same &= bool(torch.equal(loss, ordered_mean([lo for lo, _, _ in per])))
        same &= bool(torch.equal(cnt, ordered_mean([a[0].float().mean() for _, _, a in per])))
        if "emap" in st:
            zero = {"error": torch.zeros_like(st["emap"]["error"]), "decay": 0.0}
            adds = [splat_errors(zero, *a[2], a[1].detach())["error"] for _, _, a in per]
            err = st["emap"]["error"] * st["emap"]["decay"] + ordered_sum(adds)
            same &= bool(torch.equal(new["emap"]["error"], err))
        out["step_equals_mean"] = same
        check(same, "[multi] the sharded step is not the one-process mean of the per-shard "
                    "gradients, bit for bit")
        del per, mean, params
    flat = torch.cat([g.reshape(-1) for g in tree_leaves(new["params"])])
    out["collective_mb"] = flat.numel() * 4 / 1e6
    out["collective_ms"] = timed(lambda: all_mean(flat, mesh))
    del new, flat
    sums = torch.tensor(_tree_sums(st["params"]), device=dev)
    check(all(torch.equal(g, sums) for g in all_gather(sums, mesh)),
          "[multi] the replicated state differs between ranks")

    # a timed sharded bundle, then a one-rank bundle at the full batch on
    # rank 0 alone (the others wait at the barrier)
    teng.grid_interval = MULTI_TIMED_STEPS
    gen = torch.Generator(device=dev).manual_seed(5)
    box = {}

    def sharded():
        box["st"], box["loss"], box["cnt"] = teng.train_bundle_multichip(st, gen, mesh)

    out["bundle_ms_per_step"] = timed(sharded) / MULTI_TIMED_STEPS
    out["bundle_loss"] = float(box["loss"])
    check(math.isfinite(out["bundle_loss"]), "[multi] non-finite sharded loss")
    sums = torch.tensor(_tree_sums(box["st"]["params"]) + _tree_sums(box["st"]["occ"])
                        + _tree_sums(box["st"].get("emap", {})), device=dev)
    out["replica_sums_equal"] = all(torch.equal(g, sums) for g in all_gather(sums, mesh))
    check(out["replica_sums_equal"], "[multi] the replicas differ after a sharded bundle")
    del box
    if lead:
        osess = Session(device=dev)
        osess.load_file(cfg["scene"], network=cfg["net"], train_batch_size=TRAIN_BATCH)
        osess.engine.grid_interval = MULTI_TIMED_STEPS
    out["one_rank_ms_per_step"] = timed(lambda: lead and osess.engine.train_bundle(
        osess.state, torch.Generator(device=dev).manual_seed(5))) / MULTI_TIMED_STEPS
    if lead:
        del osess
    # two sharded 2-step bundles from one state and seed: the same bits
    runs = []
    teng.grid_interval = DETERMINISM_STEPS
    for _ in range(2):
        s_run, l_run, _ = teng.train_bundle_multichip(
            replicate(teng.init(0), mesh), torch.Generator(device=dev).manual_seed(9), mesh)
        runs.append((_tree_sums(s_run["params"]) + _tree_sums(s_run["occ"])
                     + _tree_sums(s_run.get("emap", {})), float(l_run)))
    out["bundles_repeat"] = runs[0] == runs[1]
    check(out["bundles_repeat"], f"[multi] rank {rank}: two sharded runs from one seed differ")
    torch.cuda.synchronize(dev)
    return out


def multi_phase(sess) -> dict:
    """[multi]: the multi-device paths on max(2, cards) ranks, one process
    a rank (parallel/mesh.py::run_ranks): NCCL with a card a rank, or on a
    one-card machine two ranks on cuda:0 joined through gloo (which carries
    their CUDA tensors' collectives through host memory; the ranks' kernels
    run on the card).  The choice is made by card count before any rank starts; a
    backend that fails to start raises.  `sess` holds the fox with its
    R=256 bake (the scene's views are rendered from it)."""
    import concurrent.futures as futures
    import json as _json

    import numpy as np
    import torch

    from sienerf_torch.io.nerf_dataset import ngp_matrix_to_nerf
    from sienerf_torch.io.png import write_png
    from sienerf_torch.parallel.mesh import run_ranks

    n_cards = torch.cuda.device_count()
    world = max(2, n_cards)
    if n_cards >= 2:
        backend, devices = "nccl", [f"cuda:{i}" for i in range(world)]
    else:
        backend, devices = "gloo", ["cuda:0"] * world
    log(f"[multi] {world} ranks on {n_cards} card(s): backend {backend}, devices {devices}"
        + ("" if n_cards >= 2 else " (one card: the ranks share it, so no speedup is "
           "expected; the figures are not a scaling result)"))
    out = {"world": world, "backend": backend, "devices": devices}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        root = tmp / "multi_scene"
        root.mkdir()
        vw, vh = MULTI_VIEW_RES
        focal = tuple(f * vw / WIDTH for f in FOCAL)
        cams = fibonacci_cameras(MULTI_VIEWS, 2.2)
        imgs = [sess.render(vw, vh, c, focal, renderer="sweep").cpu().numpy() for c in cams]
        q = [np.clip(np.rint(im * 255.0), 0, 255).astype(np.uint8) for im in imgs]
        scale_, offset = 0.33, np.asarray([0.5, 0.5, 0.5], np.float32)
        frames = []
        for i, c in enumerate(cams):
            m = np.eye(4, dtype=np.float32)
            m[:3] = ngp_matrix_to_nerf(np.asarray(c, np.float32), scale_, offset)
            frames.append({"file_path": f"v{i:03d}", "transform_matrix": m.tolist()})
        with futures.ThreadPoolExecutor(max_workers=8) as ex:
            list(ex.map(lambda i: write_png(root / f"v{i:03d}.png", q[i], level=1),
                        range(len(q))))
        (root / "transforms.json").write_text(_json.dumps(
            {"fl_x": focal[0], "fl_y": focal[1], "w": vw, "h": vh, "aabb_scale": 4,
             "scale": scale_, "offset": offset.tolist(), "frames": frames}))
        (tmp / "net.json").write_text(_json.dumps(sess.network_config))
        out["scene_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ranks = run_ranks(_multi_rank, world, backend, devices,
                          {"scene": str(root), "net": str(tmp / "net.json")},
                          timeout_s=MULTI_TIMEOUT_S)
        out["ranks_s"] = time.perf_counter() - t
    r0 = ranks[0]
    out["ranks"] = ranks
    out["launches"] = {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
    out["launches_by_rank"] = [r["launches"] for r in ranks]
    for k in ("sweep_ms", "sweep_min_t0_ms", "live_ms", "baked_ms", "sweep_one_ms",
              "bundle_ms_per_step",
              "one_rank_ms_per_step", "collective_ms", "collective_mb", "sweep_err",
              "sweep_depth_err", "live_agree", "baked_agree", "step_equals_mean",
              "replica_sums_equal", "bundles_repeat"):
        out[k] = r0[k]
    out["k1_err"] = max(r["k1_err"] for r in ranks)
    out["k2_err"] = max(r["k2_err"] for r in ranks)
    for r in ranks:
        log(f"[multi] rank {r['rank']} on {r['device']}: bake {r['bake_s']:.2f} s, launches "
            f"{r['launches']}, K1 planes max abs err {r['k1_err']:.3g}, K2 schedule "
            f"{r['k2_err']:.3g}")
    log(f"[multi] frames of view 0, every rank together: sharded {WIDTH}x{HEIGHT} sweep "
        f"{out['sweep_ms']:.2f} ms (one device {out['sweep_one_ms']:.2f} ms; the main path's "
        f"first, at min transmittance 0, {out['sweep_min_t0_ms']:.2f} ms), sharded "
        f"{MULTI_SMALL[0]}x{MULTI_SMALL[1]} live {out['live_ms']:.1f} ms, baked "
        f"{out['baked_ms']:.1f} ms; sweep at min transmittance 0 vs one device max abs err "
        f"{out['sweep_err']:.3g} (depth {out['sweep_depth_err']:.3g}), live "
        f"{100 * out['live_agree']:.2f} % / baked {100 * out['baked_agree']:.2f} % of pixels "
        f"within FRAME_TOL")
    log(f"[multi] training (a {TRAIN_BATCH}-sample batch, the rays split over {world} ranks): "
        f"sharded bundle "
        f"{out['bundle_ms_per_step']:.1f} ms a step, one-rank bundle "
        f"{out['one_rank_ms_per_step']:.1f} ms a step; the gradient mean "
        f"({out['collective_mb']:.1f} MB a rank) {out['collective_ms']:.1f} ms; step = "
        f"one-process mean bit for bit: {out['step_equals_mean']}; replicas equal: "
        f"{out['replica_sums_equal']}; two runs from one seed equal: {out['bundles_repeat']}")
    log(f"[multi] launches on the sharded paths: {out['launches_by_rank']}; scene "
        f"{out['scene_s']:.1f} s, ranks {out['ranks_s']:.1f} s")
    return out


def frame_agreement(name, got, want) -> float:
    """The share of pixels of `got` within FRAME_TOL of `want`."""
    import torch

    check(got.shape == want.shape, f"{name}: shapes differ")
    err = (got - want).abs()
    ok = (err <= FRAME_TOL["atol"] + FRAME_TOL["rtol"] * want.abs()).all(dim=-1)
    agree = float(ok.float().mean())
    log(f"  {name}: {100 * agree:.4f} % of pixels within rtol {FRAME_TOL['rtol']} atol "
        f"{FRAME_TOL['atol']} ({int((~ok).sum())} outside), max abs err {float(err.max()):.3g}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite values")
    return agree


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on the card.")
    ap.add_argument("--phase", choices=("all", "multi"), default="all",
                    help="'multi' builds the kernels and runs [multi] alone")
    phase = ap.parse_args().phase

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
    general_ptxas = {}  # (padded width, warps a block) of a general instance -> ptxas's lines
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                log(f"  {name}: {entry}")
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
                args = re.search(r"shade_general_kernelILi(\d+)ELi(\d+)ELi(\d+)E", entry)
                if args:
                    w, ncons, p = (int(a) for a in args.groups())
                    key = (w, 4 * ncons + p)
                    general_ptxas[key] = (general_ptxas.get(key, "") + line.strip()
                                          .removeprefix("ptxas info    : ") + "; ")
    k1_blocks, k1_threads = kernel_occupancy()
    log(f"  shade: {k1_blocks} blocks of {k1_threads} threads "
        f"({k1_blocks * k1_threads // 32} warps) fit an SM")
    if phase == "multi":
        return multi_only(smi, t_all)

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
    probe = bench_gather.run({"g1", "g2"}, dev, reps=GATHER_REPS,
                             out=lambda l: log(f"[gather] {l}"))
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
    k2_axis_ms, k2_planar_ms, k2_spread, k2_axis_bound = {}, {}, {}, {}

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
        k2_axis_bound[axis] = k2_bound_of(view, g["flip"], *args[1:], R, K)
        # the generic path: the same values in a channel-planar volume
        planar = view.contiguous()
        check(planar.stride(2) != 1, "the channel-planar copy is channel-last")
        got = sweep_composite_kernel(planar, *args[1:], **kw)
        torch.cuda.synchronize()
        k2_err = max(k2_err, hold(f"axis {axis} channel-planar", got, want_nearest))
        k2_planar_ms[axis] = cuda_ms(lambda: sweep_composite_kernel(planar, *args[1:], **kw), 10)
        del planar
        b = k2_axis_bound[axis]
        log(f"[K2] axis {axis}: {k2_axis_ms[axis]:.4f} ms (ten timings "
            f"{k2_spread[axis][0]:.4f}-{k2_spread[axis][1]:.4f}); channel-planar copy "
            f"{k2_planar_ms[axis]:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
            f"{b['bytes'] / 1e9:.4f} GB, {b['samples']} samples, {b['texels']} texels)")
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

    # one tile-2^17 frame, timed: the bake and the sweep frames before it
    # have warmed the field's matmuls.  (A 720p frame at tile 2^14 takes
    # 22-42 s; it is not run, to keep the script inside its limit.)
    big_stats = {}
    t = time.perf_counter()
    live0 = big = live_frame(cams[0], tile=LIVE_BIG_TILE, stats=big_stats)
    big_ms = [1e3 * (time.perf_counter() - t)]
    live_stats, live_med = big_stats, big_ms[0]
    check(live0.shape == (HEIGHT, WIDTH, 4), f"live frame shape {tuple(live0.shape)}")
    check(bool(torch.isfinite(live0).all()), "non-finite live frame")
    check(float(live0[..., 3].mean()) > 0.05 and float(live0[..., :3].std()) > 1e-3,
          "empty or constant live frame")
    log(f"[live] 1280x720 spp1 tile 2^17: one frame {live_med:.1f} ms, "
        f"{big_stats['rounds']} rounds, {big_stats['samples']} samples, host waited "
        f"{1e3 * big_stats['host_wait_s']:.1f} ms for the device "
        f"({100 * 1e3 * big_stats['host_wait_s'] / live_med:.1f} % of the frame)")
    phases = {"sync_phases": True}
    pw, ph = LIVE_SPLIT_FRAME
    t = time.perf_counter()
    sess.render(pw, ph, cams[0], tuple(f * pw / WIDTH for f in FOCAL), renderer="live",
                tile=LIVE_BIG_TILE, stats=phases)
    torch.cuda.synchronize()
    synced_ms = 1e3 * (time.perf_counter() - t)
    log(f"[live] where the time goes (one {pw}x{ph} tile-2^17 frame with a device sync after "
        f"every phase, {synced_ms:.1f} ms): "
        + ", ".join(f"{k} {1e3 * v:.1f} ms" for k, v in phases["phase_s"].items()))
    # per-ray results do not depend on the tile (a frame of many refills)
    sw, sh = LIVE_SMALL_TILE_CHECK
    focal_t = tuple(f * sw / WIDTH for f in FOCAL)
    few = sess.render(sw, sh, cams[0], focal_t, renderer="live", tile=LIVE_SMALL_TILE)
    many = sess.render(sw, sh, cams[0], focal_t, renderer="live", tile=LIVE_BIG_TILE)
    compare(f"live {sw}x{sh} frame tile {LIVE_SMALL_TILE} vs tile 2^17", few, many, rtol=0.0,
            atol=1e-6)
    del few, many
    # the device's busy share of a tile-2^17 frame: the kernels' summed time in
    # a profiler trace over the untraced frame's median time
    busy_ms, n_kernels, _ = device_trace(lambda: live_frame(cams[0], tile=LIVE_BIG_TILE))
    if busy_ms > 0:
        log(f"[live] tile 2^17 trace: {n_kernels} device kernels and copies, busy "
            f"{busy_ms:.1f} ms = "
            f"{100 * busy_ms / statistics.median(big_ms):.1f} % of the frame "
            f"({n_kernels / big_stats['rounds']:.0f} kernels a round)")
    else:
        log("[live] device busy share: not measured (the trace holds no device time)")

    # the same port code on the CPU, at LIVE_SMALL
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
    # (view 0 at 1280x720, the others at QUALITY_SMALL)
    quality = []
    qw, qh = QUALITY_SMALL
    q_focal = tuple(f * qw / WIDTH for f in FOCAL)
    for i, cam in enumerate(cams):
        # through the large tile: per-ray results do not depend on it
        if i == 0:
            lv, sw_img = live0, frames[0, 1]
        else:
            lv = sess.render(qw, qh, cam, q_focal, renderer="live", tile=LIVE_BIG_TILE)
            sw_img = sess.render(qw, qh, cam, q_focal, spp=1, renderer="sweep")
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
    # K2: as k2_bound counts it, on view 0
    b0 = k2_axis_bound[g0["axis"]]
    k2_samples, k2_texels, k2_bytes = b0["samples"], b0["texels"], b0["bytes"]
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
    # -- 8a. every configs/nerf/*.json through K1 and K2 (K1's general path
    # for every colour MLP but the fox's), and K1 timed on the fox's rows
    del vol, view, frames, big, small, small_cpu
    torch.cuda.empty_cache()
    t = time.time()
    cf = configs_phase(sess, rows, scale, n_live, dev, cuda_ms, general_ptxas)
    cf["phase_s"] = time.time() - t
    log(f"[configs] phase in {cf['phase_s']:.1f} s: {len(cf['by_config'])} configs, launches "
        f"{cf['launches']}, K1 max abs err {cf['k1_max_abs_err']:.3g}")
    # -- 8b. the baked gather renderer: the fox's bake, 720p frames, the
    # gathers on a frame's ids, the knobs, the card against the CPU
    torch.cuda.empty_cache()
    t = time.time()
    bk = baked_phase(sess, live0, cams[0], cpu_sess, bake_s, dev)
    bk["phase_s"] = time.time() - t
    log(f"[baked] phase in {bk['phase_s']:.1f} s")
    # -- 9. the training path: teacher views -> train -> bake -> sweep frames
    del live0, cpu_sess
    torch.cuda.empty_cache()
    t = time.time()
    tr = train_phase(sess, dev, cuda_ms)
    log(f"[train] phase in {time.time() - t:.1f} s")
    # -- 10. the hybrid mesh + NeRF path
    torch.cuda.empty_cache()
    t = time.time()
    hy = hybrid_phase(sess, tr, dev, cuda_ms)
    log(f"[hybrid] phase in {time.time() - t:.1f} s (host max RSS {host_rss_gib():.1f} GiB)")
    # -- 10b. the trained student's fine render grid, the triplane NeRF, and
    # a PNG dataset of the training views through Session.load_file
    torch.cuda.empty_cache()
    t = time.time()
    fn = fine_phase(tr, cams[0], dev)
    fn["phase_s"] = time.time() - t
    log(f"[fine] phase in {fn['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t = time.time()
    tp = triplane_phase(tr, sess.state["occ"]["bitfield"], dev)
    tp["phase_s"] = time.time() - t
    log(f"[triplane] phase in {tp['phase_s']:.1f} s")
    torch.cuda.empty_cache()
    t = time.time()
    with tempfile.TemporaryDirectory() as png_dir:
        pg = png_phase(tr, sess.network_config, dev, Path(png_dir))
        pg["phase_s"] = time.time() - t
        log(f"[png] phase in {pg['phase_s']:.1f} s")
        # -- 10b'. the corner table layout on the training views; the
        # front-ends on the fox session and the CLI twin on the [png] scene
        torch.cuda.empty_cache()
        t = time.time()
        cn = corner_phase(tr, dev, cuda_ms)
        cn["phase_s"] = time.time() - t
        log(f"[corner] phase in {cn['phase_s']:.1f} s")
        torch.cuda.empty_cache()
        t = time.time()
        fe = frontends_phase(sess, dev, Path(png_dir) / "png_scene",
                             Path(png_dir) / "png_net.json", Path(png_dir))
        fe["phase_s"] = time.time() - t
        log(f"[frontends] phase in {fe['phase_s']:.1f} s")
    # -- 10c. the trainer's optional learners on the student, at full width
    torch.cuda.empty_cache()
    t = time.time()
    ln = learners_phase(sess, tr, dev, cuda_ms)
    ln["phase_s"] = time.time() - t
    log(f"[learners] phase in {ln['phase_s']:.1f} s (host max RSS {host_rss_gib():.1f} GiB)")
    # -- 11. the image, SDF and volume modes and mesh export; none of them
    # launches K1, K2, G1 or G2 (the JAX package runs them in XLA alone)
    for key in ("engine", "state", "dataset"):  # the student's device memory
        tr.pop(key)
    torch.cuda.empty_cache()
    modes, modes_s = {}, {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        t = time.time()
        modes["image"] = image_phase(dev, tmp)
        modes_s["image"] = time.time() - t
        log(f"[image] phase in {modes_s['image']:.1f} s (host max RSS {host_rss_gib():.1f} GiB, "
            f"card memory in use {torch.cuda.memory_allocated() / 1e9:.1f} GB)")
        torch.cuda.empty_cache()
        t = time.time()
        modes["sdf"], sdf_sess = sdf_phase(dev, tmp)
        modes_s["sdf"] = time.time() - t
        log(f"[sdf] phase in {modes_s['sdf']:.1f} s (host max RSS {host_rss_gib():.1f} GiB, "
            f"card memory in use {torch.cuda.memory_allocated() / 1e9:.1f} GB)")
        t = time.time()
        modes["takikawa"] = takikawa_phase(dev, tmp / "scene.obj")
        modes_s["takikawa"] = time.time() - t
        log(f"[takikawa] phase in {modes_s['takikawa']:.1f} s (host max RSS "
            f"{host_rss_gib():.1f} GiB)")
        torch.cuda.empty_cache()
        t = time.time()
        modes["volume"] = volume_phase(dev, tmp)
        modes_s["volume"] = time.time() - t
        log(f"[volume] phase in {modes_s['volume']:.1f} s (host max RSS {host_rss_gib():.1f} GiB, "
            f"card memory in use {torch.cuda.memory_allocated() / 1e9:.1f} GB)")
        torch.cuda.empty_cache()
        t = time.time()
        modes["mesh"] = mesh_phase(sess, sdf_sess, tmp)
        modes_s["mesh"] = time.time() - t
        log(f"[mesh] phase in {modes_s['mesh']:.1f} s (host max RSS {host_rss_gib():.1f} GiB, "
            f"card memory in use {torch.cuda.memory_allocated() / 1e9:.1f} GB)")
        del sdf_sess
    for name in ("image", "sdf", "takikawa", "volume", "mesh"):
        check(not any(modes[name]["launches"].values()),
              f"[{name}] launched a kernel of the NeRF paths: {modes[name]['launches']}")
    log(f"[modes] image, SDF, Takikawa SDF, volume and mesh phases in "
        f"{sum(modes_s.values()):.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in modes_s.items())}); launches of K1, K2, "
        f"G1, G2 on their paths: none")
    # -- 12. the multi-device paths on their own ranks
    torch.cuda.empty_cache()
    t = time.time()
    mu = multi_phase(sess)
    mu["phase_s"] = time.time() - t
    log(f"[multi] phase in {mu['phase_s']:.1f} s ({smi})")
    log(f"[done] {time.time() - t_all:.1f} s")

    kernels = [
        {"name": "shade", "route": "cuda", "source": "sienerf_torch/csrc/shade.cu",
         "replaces": REPLACES["shade"], "launches": launches["shade"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound, "bound_by": k1_by, "library_ms": None,
         "launches_train_path": tr["path_launches"]["shade"],
         "launches_teacher_views": tr["teacher_launches"]["shade"],
         "launches_hybrid_path": hy["launches"]["shade"],
         "max_abs_err_hybrid": hy["k1_err"],
         "launches_configs_path": cf["launches"]["shade"],
         "max_abs_err_configs": {k: v["k1_max_abs_err"] for k, v in cf["by_config"].items()},
         "configs_timed": cf["timed"], "configs_wide": cf["wide"],
         "launches_triplane_path": tp["launches"]["shade"],
         "max_abs_err_triplane": tp["k1_max_abs_err"],
         "launches_learners_path": ln["launches_by_kernel"]["shade"],
         "max_abs_err_learners_frame": ln["A_frame_max_abs_err"],
         "launches_corner_path": cn["launches"]["shade"],
         "launches_frontends_path": fe["launches"]["shade"]},
        {"name": "sweep", "route": "cuda", "source": "sienerf_torch/csrc/sweep.cu",
         "replaces": REPLACES["sweep"], "launches": launches["sweep"],
         "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
         "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
         "ms_by_axis": k2_axis_ms, "channel_planar_ms_by_axis": k2_planar_ms,
         "launches_train_path": tr["path_launches"]["sweep"],
         "launches_teacher_views": tr["teacher_launches"]["sweep"],
         "launches_hybrid_path": hy["launches"]["sweep"],
         "max_abs_err_hybrid": hy["k2_err"], "hybrid_t_stop_ms": hy["k2_ms"],
         "hybrid_t_stop_plain_ms": hy["k2_plain_ms"],
         "bound_ms_by_axis": {a: b["bound_ms"] for a, b in k2_axis_bound.items()},
         "bound_by_by_axis": {a: b["bound_by"] for a, b in k2_axis_bound.items()},
         "hybrid_t_stop_bound_ms": hy["k2_bound"]["bound_ms"],
         "hybrid_t_stop_bound_by": hy["k2_bound"]["bound_by"],
         "launches_configs_path": cf["launches"]["sweep"],
         "launches_triplane_path": tp["launches"]["sweep"],
         "max_abs_err_triplane": tp["k2_max_abs_err"],
         "launches_learners_path": ln["launches_by_kernel"]["sweep"],
         "max_abs_err_learners": ln["B_k2_max_abs_err"], "learners_ms": ln["B_k2_ms"],
         "launches_corner_path": cn["launches"]["sweep"],
         "launches_frontends_path": fe["launches"]["sweep"]},
    ]
    for name, tag, r in (("gather_rows", "G1", g1_main), ("gather_small", "G2", g2_main)):
        fr = bk["gathers"][tag]  # at the baked frame's shapes, on its ids
        kernels.append(
            {"name": name, "route": "cuda", "source": "sienerf_torch/csrc/gather.cu",
             "replaces": REPLACES[name], "launches": launches_probe[name],
             "max_abs_err": 0.0, "ms": r["ms"], "call_ms": r["call_ms"],
             "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"], "shape": r["shape"],
             "ms_by_shape": {x["shape"]: x["ms"] for x in probe if x["name"] == tag},
             "baked_launches": bk["launches"][name],
             "baked_launches_hybrid": hy["baked"]["launches"][name],
             "baked_ms": fr["ms"], "baked_call_ms": fr["call_ms"],
             "baked_plain_ms": fr["plain_ms"], "baked_bound_ms": fr["bound_ms"],
             "baked_library_ms": fr["library_ms"], "baked_shape": fr["shape"],
             "launches_learners_path": ln["launches_by_kernel"][name],
             "launches_corner_path": cn["launches"][name],
             "launches_frontends_path": fe["launches"][name]})
    log(json.dumps({"frame_ms": frame_med,
                    "frame_ms_by_view": [statistics.median(ms) for ms in frame_ms_by_view],
                    "bake_s": bake_s, "live_frame_ms": live_med,
                    "live_rounds": live_stats["rounds"],
                    "live_big_tile_ms": statistics.median(big_ms),
                    "sweep_vs_live_psnr_db": [q[0] for q in quality],
                    "sweep_vs_live_ssim": [q[1] for q in quality],
                    "train_ms_per_step": tr["ms_per_step"], "train_steps": tr["steps"],
                    "train_loss_first_last": tr["loss_first_last"],
                    "heldout_psnr_db": tr["heldout_psnr_db"],
                    "heldout_psnr_db_untrained": statistics.mean(
                        tr["heldout"]["untrained"]["psnr_db"]),
                    "train_phase_ms_per_step": tr.get("phase_ms_per_step"),
                    "train_peak_mem_gb": tr["peak_mem_gb"],
                    "hash_fwd_ms": tr["hash_fwd_ms"], "hash_bwd_ms": tr["hash_bwd_ms"],
                    "hash_bwd_alone_ms": tr["hash_bwd_alone_ms"],
                    "hash_bwd_index_add_ms": tr["hash_bwd_index_add_ms"],
                    "card_vs_cpu_flips": tr["flips"],
                    "hybrid": {k: hy[k] for k in (
                        "frame_ms", "frame_ms_runs", "split_ms", "probe_bake_s",
                        "first_frame_s", "mesh_cover", "frame_vs_plain_agree",
                        "sweep_vs_live_psnr_db", "sweep_vs_live_ssim", "cpu_agree",
                        "bvh_frame_ms", "bvh_frame_ms_runs", "bvh_launches", "tiers",
                        "roundtrip_equal", "determinism")},
                    "baked": {k: bk[k] for k in (
                        "frame_ms", "frame_ms_runs", "first_frame_s", "counts", "split_ms",
                        "host_wait_ms", "kernels_a_round", "busy_ms", "g2_device_ms",
                        "psnr_vs_live_db", "ssim_vs_live", "knobs", "trilinear_bake_s",
                        "trilinear_psnr_db", "cpu_agree", "table_bytes", "phase_s")},
                    "baked_hybrid": {k: hy["baked"][k] for k in (
                        "frame_ms", "frame_ms_runs", "split_ms", "load_and_bake_s",
                        "psnr_vs_live_db", "ssim_vs_live", "phase_s")},
                    "modes": modes, "modes_s": modes_s,
                    "configs": cf, "fine": fn, "triplane": tp, "png": pg,
                    "learners": ln, "corner": cn, "frontends": fe}))
    for k in kernels:  # the image, SDF, volume and mesh paths launch none
        k["launches_modes_paths"] = sum(m["launches"][k["name"]] for m in modes.values())
        k["launches_multi_path"] = mu["launches"][k["name"]]
        k["launches_multi_path_by_rank"] = [r[k["name"]] for r in mu["launches_by_rank"]]
    kernels[0]["max_abs_err_multi_planes"] = mu["k1_err"]
    kernels[1]["max_abs_err_multi_schedule"] = mu["k2_err"]
    k3 = hy["k3"]  # no TPU kernel computes K3: the JAX package walks the BVH in a loop
    kernels.append({"name": "bvh_walk", "route": "cuda", "source": "sienerf_torch/csrc/bvh.cu",
                    "replaces": None, "launches": k3["launches"],
                    "max_abs_err": 0.0 if all(r["equal"] for r in k3["by_ray_set"].values())
                    else None, "ms": k3["ms"], "plain_ms": k3["plain_ms"],
                    "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"], "library_ms": None,
                    "by_ray_set": k3["by_ray_set"], "hybrid_bvh_frame_ms": hy["bvh_frame_ms"]})
    log(json.dumps({"multi": {k: v for k, v in mu.items() if k != "ranks"}}))
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def multi_only(smi: str, t_all: float) -> int:
    """--phase multi: the fox snapshot and its R=256 bake, then [multi]
    alone; the same last line."""
    import torch

    from sienerf_torch.session import Session

    sess = Session(device="cuda")
    sess.load_snapshot(SNAP)
    sess.bake(resolution=BAKE_RES)
    t = time.time()
    mu = multi_phase(sess)
    mu["phase_s"] = time.time() - t
    log(f"[multi] phase in {mu['phase_s']:.1f} s ({smi})")
    log(f"[done] {time.time() - t_all:.1f} s")
    print(json.dumps({"multi": {k: v for k, v in mu.items() if k != "ranks"}}))
    log(smi)
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
