"""Runs one cell of BENCHMARK.json once and prints its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up (set-up, `setup_s`), measures for `--seconds`, checks
what the timed path produced against the plain reference
(perfbench/compare.py), and prints as its last line one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines on standard error).  Exits non-zero, printing no
result, without enough CUDA cards, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here: imports, build, load, bake, warm-up

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from perfbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sienerf_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: the port's name begins with the package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit_w():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def result_line(bench: dict, cell: dict, out: dict, trace: bool, device_info: dict,
                root=spec.ROOT) -> dict:
    """The contract's result object from a kind's run() output."""
    from perfbench.compare import judge, load_limits
    from perfbench.trace import idle_gaps, top_ops, union_ns

    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], trace):
        if trace:
            v = spec.metric_reader(m["name"], root)(out["ctx"])
        else:
            v = out["end_to_end"].get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    correct, checks = judge(out["numbers"], load_limits(cell["name"], root))
    device = dict(device_info, memory_peak_bytes=out["memory_peak_bytes"])
    line = {"correct": bool(correct and out["failed"] == 0), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    events = out["ctx"].get("events")
    if trace and events is not None:
        device["busy_s"] = union_ns(events) / 1e9
        device["window_s"] = out["ctx"]["window_s"]
        line["breakdown"] = {"device_ops": top_ops(events),
                             "idle_gaps": idle_gaps(events, out["gap_label"])}
    line["checks"] = checks
    return line


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, device_info: dict,
             overrides: dict | None = None, root=spec.ROOT):
    """Everything of a run after the look for cards -> (result line, every
    number the check computed).  `overrides` (smaller sizes) are for tests."""
    bench = spec.load_benchmark(root)
    cell = spec.find_cell(bench, workload)
    config = spec.load_config(bench, cell["config"], root)
    traffic = spec.load_traffic(cell["traffic"], root)
    out = spec.kind_module(traffic["kind"], root).run(cell, config, traffic, seed, seconds, trace,
                                                 device, T0, overrides=overrides)
    return result_line(bench, cell, out, trace, device_info, root), out["numbers"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = spec.load_benchmark()
    chips = spec.find_cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", info)
    line["device"]["power_limit_w"] = power_limit_w()  # after the window: not set-up
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    print(json.dumps(numbers), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
