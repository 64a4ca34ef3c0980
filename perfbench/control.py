"""The control of a cell: the plain reference put in the program's place,
computed in the precision below the one the configuration states (its MLPs
on e4m3 operands instead of bf16), and compared with the reference as a
run compares the program: the cell's sampled frames, the same numbers.  It
has to come out not correct.

    python3 -m perfbench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed: the numbers and whether they pass the cell's
limits.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import generator, spec
from perfbench.compare import frame_numbers, judge, load_limits


def control_numbers(workload: str, seed: int, device, overrides: dict | None = None,
                    precision: str = "fp8", root=spec.ROOT) -> dict:
    from perfbench.kinds.video import frame_format, reference_frames

    overrides = overrides or {}
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, workload)
    config = spec.patched(spec.load_config(bench, cell["config"], root),
                          overrides.get("config", {}))
    traffic = spec.load_traffic(cell["traffic"], root)
    fmt = frame_format(traffic, overrides)
    cams = generator.camera_path(dict(traffic["path"], **overrides.get("path", {})), seed)
    sample = generator.check_sample(cams, seed, traffic["check"]["frames_per_axis"])
    ref = reference_frames(config, seed, cams, sample, fmt, device, "bf16")
    low = reference_frames(config, seed, cams, sample, fmt, device, precision)
    return frame_numbers([(low[p], ref[p]) for p in sample])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    limits = load_limits(args.workload)
    for seed in args.seeds:
        numbers = control_numbers(args.workload, seed, "cuda")
        ok, _ = judge(numbers, limits)
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": "fp8",
                          "numbers": numbers, "passes_limits": ok}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
