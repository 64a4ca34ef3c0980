"""Shade probe: where K1's general path spends its time on one NVIDIA card.

Builds csrc/shade.cu again with compile-time switches of the general kernel
(each into its own library under csrc/build/probe/) and runs every build on
the fox's R=256 bake (data/fox_render.snap through Session.bake, camera 0
of chip_smoke.py) with the colour MLPs the general path serves:

  32-3, 32-64-3, 32-64x3-3, 32-128x2-3, 32-128x4-3  (seeded weights)
  fox   the fox's own 32-64-64-3 through the general path

Builds, by name:
  default   the library the port loads
  no_mlp    -DGEN_NO_MLP: the consumers skip the MLP and store zeros, so
            the time is the producers' walk, SH and hand-over alone
  profile   -DGEN_PROFILE: clock cycles by phase of block 0's first
            consumer thread (a stage: waiting for it, reading and releasing
            it, the MLP with the previous stage's epilogue) and first
            producer thread (a tile: waiting for its rows; a batch of 32
            kept vertices: computing them, waiting for their stage's slot,
            writing and counting them)
  parent=<path to an earlier shade.cu>: that source's shade_general_launch
            (the same C interface; weights in the "fragment" layout, width
            padded to 16, as the earlier general kernel took them), timed in
            turns with the others

    python3 -m sienerf_torch.tools.probe_shade [default] [no_mlp] [profile] [parent=...]

With no argument: default, no_mlp, profile.  Every build but no_mlp is held
to the plain version (rtol 2e-2 / atol 2e-3) before it is timed; times are
the median of ten single launches between CUDA events, the builds in turns.
Prints one line a shape and build and, last, one JSON object.  Needs the
card: without one it exits non-zero.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sienerf_torch.ops import cuda_lib
from sienerf_torch.ops.shade import _shade_general, shade_volume_plain
from sienerf_torch.tools.bench_gather import cuda_ms

ROOT = Path(__file__).resolve().parents[2]
SNAP = ROOT / "data" / "fox_render.snap"
PROBE_DIR = cuda_lib.BUILD_DIR / "probe"
SHAPES = {
    "32-3": ((32, 3),),
    "32-64-3": ((32, 64), (64, 3)),
    "32-64x3-3": ((32, 64), (64, 64), (64, 64), (64, 3)),
    "32-128x2-3": ((32, 128), (128, 128), (128, 3)),
    "32-128x4-3": ((32, 128), (128, 128), (128, 128), (128, 128), (128, 3)),
    "fox": None,
}
PHASES = {0: "wait_stage", 1: "read_release", 2: "mlp_epilogue", 8: "wait_rows",
          10: "batch_compute", 11: "wait_slot", 12: "write_count"}
COUNTS = {4: "stages", 13: "batches", 14: "tiles", 15: "producer_cycles"}


def _defines(name: str) -> list[str]:
    return {"no_mlp": ["-DGEN_NO_MLP"], "profile": ["-DGEN_PROFILE"]}.get(name, [])


def build(names) -> dict[str, ctypes.CDLL]:
    """One library a build, compiled in parallel."""
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = name.split("=", 1)[1] if name.startswith("parent=") else cuda_lib.CSRC / "shade.cu"
        cmd = [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, *_defines(name), "-o",
               str(PROBE_DIR / f"libshade_{_tag(name)}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"build {name} failed:\n{out}")
        libs[name] = ctypes.CDLL(str(PROBE_DIR / f"libshade_{_tag(name)}.so"))
    return libs


def _tag(name: str) -> str:
    return "parent" if name.startswith("parent=") else name


def _parent_call(lib, rows, scale, o, ws, kw):
    """The earlier general kernel through its own C interface."""
    from sienerf_torch.ops.shade import _ACT_CODE, pack_shade_weights, shade_mlp_layout

    n_hidden, width = shade_mlp_layout([w.shape for w in ws])
    packed = pack_shade_weights(ws)  # the fragment layout, width padded to 16
    R, K = kw["resolution"], kw["n_cascades"]
    out = torch.empty((K, R + 1, R + 1, R + 1, 4), dtype=torch.bfloat16, device=rows.device)
    fn = lib.shade_general_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    n_sms = torch.cuda.get_device_properties(rows.device).multi_processor_count
    acts = (_ACT_CODE[kw["density_act"]], _ACT_CODE[kw["rgb_act"]])

    def run():
        code = fn(rows.data_ptr(), scale.data_ptr(), o.data_ptr(), packed.data_ptr(),
                  packed.numel() // 2, n_hidden, width, out.data_ptr(), R, K, *acts, n_sms,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"the earlier general kernel failed to launch ({code})")
        return out.permute(0, 1, 4, 2, 3)
    return run


def _profile(lib, fn) -> dict:
    """fn() once with the phase counters from zero -> cycles a stage, a
    tile or a batch by phase, and the counts."""
    prof = lib.shade_prof
    prof.restype = ctypes.c_int
    prof.argtypes = [ctypes.c_void_p, ctypes.c_int]
    buf = (ctypes.c_ulonglong * 16)()
    prof(None, 1)
    fn()
    torch.cuda.synchronize()
    prof(ctypes.cast(buf, ctypes.c_void_p), 0)
    v = list(buf)
    per = {0: 4, 1: 4, 2: 4, 8: 14, 10: 13, 11: 13, 12: 13}
    out = {name: v[i] / max(v[per[i]], 1) for i, name in PHASES.items()}
    out.update({name: v[i] for i, name in COUNTS.items()})
    return out


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("probe_shade: no CUDA device", file=sys.stderr)
        return 2
    from sienerf_torch.session import Session
    from sienerf_torch.utils.camera import look_at_matrix

    names = argv or ["default", "no_mlp", "profile"]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    t = time.time()
    libs = build(names)
    print(f"card: {smi}; {len(libs)} builds in {time.time() - t:.1f} s", flush=True)
    sess = Session(device=dev)
    sess.load_snapshot(SNAP)
    grid, meta = sess.bake(resolution=256)
    rows, scale = grid["rows"], grid["scale"]
    kw = dict(resolution=meta["resolution"], n_cascades=meta["n_cascades"],
              density_act=sess.engine.net.density_activation,
              rgb_act=sess.engine.net.rgb_activation)
    cam = look_at_matrix([2.1, 0.5, 0.6], [0.5, 0.5, 0.5])
    o = torch.as_tensor(np.asarray(cam, np.float32)[:3, 3], device=dev)
    kept = int((rows[:, 0] != -32768).sum())
    result = {"card": smi, "kept": kept, "shapes": {}}
    for shape, dims in SHAPES.items():
        if dims is None:
            ws = sess.state["params"]["rgb_mlp"]
        else:
            rng = np.random.default_rng(7)
            ws = [torch.from_numpy(rng.normal(0, 1 / np.sqrt(a), (a, b)).astype(np.float32))
                  .to(dev) for a, b in dims]
        want = shade_volume_plain(rows, scale, o, ws, **kw)
        res = {}
        calls = {name: (_parent_call(libs[name], rows, scale, o, ws, kw)
                        if name.startswith("parent=")
                        else (lambda: _shade_general(rows, scale, o, ws, **kw)))
                 for name in names}
        for name in names:
            cuda_lib._loaded["shade"] = libs[name]
            got = calls[name]()
            torch.cuda.synchronize()
            if name != "no_mlp":
                err = (got.float() - want.float()).abs()
                bad = int((err > 2e-3 + 2e-2 * want.float().abs()).sum())
                if bad:
                    raise RuntimeError(f"{shape} {name}: {bad} values differ from plain")
            del got
        for name in names + names[::-1]:  # in turns
            cuda_lib._loaded["shade"] = libs[name]
            res.setdefault(_tag(name), {"ms": []})["ms"] += [
                cuda_ms(calls[name], 1, warmup=1) for _ in range(5)]
        for name in names:
            r = res[_tag(name)]
            r["ms"] = statistics.median(r["ms"])
            if name == "profile":
                cuda_lib._loaded["shade"] = libs[name]
                r["cycles"] = _profile(libs[name],
                                       lambda: _shade_general(rows, scale, o, ws, **kw))
            print(f"{shape} {_tag(name)}: {r['ms']:.3f} ms"
                  + (f"; {json.dumps({k: round(v) for k, v in r['cycles'].items()})}"
                     if "cycles" in r else ""), flush=True)
        result["shapes"][shape] = res
        del want
    cuda_lib._loaded.pop("shade", None)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
