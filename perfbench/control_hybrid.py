"""The control of a cell of the kinds perfbench/control.py (which runs the
video kind's reference) does not run: the cell's own plain reference put
in the program's place, computed in the precision below the one the
configuration states, and compared with the reference as a run compares
the program: the cell's sampled frames, the same numbers.  It has to come
out not correct.
- hybrid (reference/hybrid.py): the MLPs on e4m3 operands instead of
  bf16, and the mesh pass's vertices, origins and directions rounded to
  bf16;
- view (reference/view.py, through kinds/view.py): the MLPs on e4m3
  operands.

    python3 -m perfbench.control_hybrid --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers and whether they pass the cell's
limits.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

from perfbench import generator, scene, spec
from perfbench.compare import frame_numbers, judge, load_limits


PRECISION = {"hybrid": "fp8, bf16 mesh rays", "view": "fp8"}


def control_numbers(workload: str, seed: int, device, overrides: dict | None = None,
                    precision: str = "fp8", mesh_precision: str | None = "bf16",
                    root=spec.ROOT) -> dict:
    overrides = overrides or {}
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, workload)
    config = spec.patched(spec.load_config(bench, cell["config"], root),
                          overrides.get("config", {}))
    traffic = spec.load_traffic(cell["traffic"], root)
    cams = generator.camera_path(dict(traffic["path"], **overrides.get("path", {})), seed)
    sample = generator.check_sample(cams, seed, traffic["check"]["frames_per_axis"])
    if traffic["kind"] == "view":
        from perfbench.kinds import video, view

        fmt = video.frame_format(traffic, overrides)
        ref = view.reference_frames(config, seed, cams, sample, fmt, device, "bf16")
        low = view.reference_frames(config, seed, cams, sample, fmt, device, precision)
        return frame_numbers([(low[p], ref[p]) for p in sample])
    if traffic["kind"] != "hybrid":
        raise ValueError(f"{workload}: perfbench/control.py runs the {traffic['kind']!r} kind")
    from perfbench.kinds.hybrid import frame_format
    from perfbench.reference import hybrid as ref_hybrid

    fmt = frame_format(traffic, overrides)
    directory = Path(tempfile.mkdtemp(prefix="perfbench_control_"))
    try:
        scene.write_scene(config, seed, directory)
        ref = ref_hybrid.render(config, seed, directory, cams, sample, fmt, device)
        low = ref_hybrid.render(config, seed, directory, cams, sample, fmt, device, precision,
                                mesh_precision)
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    return frame_numbers([(low[p], ref[p]) for p in sample])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    limits = load_limits(args.workload)
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    kind = spec.load_traffic(cell["traffic"])["kind"]
    for seed in args.seeds:
        numbers = control_numbers(args.workload, seed, "cuda")
        ok, _ = judge(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "precision": PRECISION.get(kind), "numbers": numbers,
                          "passes_limits": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
