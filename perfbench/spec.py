"""Finds what BENCHMARK.json names, by name, under a checkout's root.

- a cell: an entry of `workloads`;
- its configuration: the file its `configs` entry names;
- its traffic mix: `perfbench/traffic/<traffic>.json`, whose "kind" names
  the module `perfbench/kinds/<kind>.py` that generates and serves it;
- a per-layer metric: `perfbench/metrics/<name>.py`, whose `read(ctx)`
  returns the metric's value or None.

A configuration, a traffic mix or a metric is added as new files and new
entries in BENCHMARK.json; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((Path(root) / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "perfbench" / "traffic" / f"{name}.json").read_text())


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(kind: str, root: Path = ROOT):
    """The module that runs a traffic kind: run(cell, config, traffic, args)."""
    return _module(Path(root) / "perfbench" / "kinds" / f"{kind}.py", f"perfbench_kind_{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """perfbench/metrics/<name>.py's read(ctx)."""
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    return _module(path, "perfbench_metric_" + name.replace(".", "_")).read


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end metrics, or with `trace`
    its per-layer metrics (an entry without "workloads" is every cell's)."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def patched(config: dict, patches: dict) -> dict:
    """`config` with each of `patches`' groups updated key by key (tests
    shrink a network so: {"encoding": {"log2_hashmap_size": 12}})."""
    for key, patch in patches.items():
        config = dict(config, **{key: dict(config[key], **patch)})
    return config
