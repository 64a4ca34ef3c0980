"""BENCHMARK.json and the files it names: each configuration, traffic mix,
limit file and metric is found by name, and a new one is added as new files
and new entries without editing a file that is there."""

from __future__ import annotations

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_the_file_keeps_to_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert bench["paths"] == ["perfbench"]
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in [m["name"] for m in bench["end_to_end"]]
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    ends = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in ends
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("part", ["config", "traffic", "limits", "kind"])
def test_every_cell_finds_its_files_by_name(bench, part):
    from perfbench.compare import load_limits

    for w in bench["workloads"]:
        if part == "config":
            cfg = spec.load_config(bench, w["config"])
            assert {"encoding", "network", "rgb_network", "weights"} <= set(cfg)
        elif part == "traffic":
            assert "kind" in spec.load_traffic(w["traffic"])
        elif part == "limits":
            assert load_limits(w["name"])
        else:
            assert callable(spec.kind_module(spec.load_traffic(w["traffic"])["kind"]).run)


def test_every_metric_has_a_reader_and_every_cell_reports_enough(bench):
    for m in bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in bench["workloads"]:
        e2e = [m["name"] for m in spec.metrics_of(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.metrics_of(bench, w["name"], True)
        assert layer
        for m in layer:  # a per-layer metric's end-to-end metric is the cell's
            assert m["moves"] in e2e
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_configuration_traffic_and_metric_are_added_as_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(spec.PACKAGE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = spec.load_benchmark()
    before = _digests(root)
    # the new files
    cfg = spec.load_config(bench, "base84")
    (root / "perfbench/configs/base84_wide.json").write_text(
        json.dumps(dict(cfg, rgb_network=dict(cfg["rgb_network"], n_neurons=128))))
    traffic = spec.load_traffic("video1080")
    (root / "perfbench/traffic/video720.json").write_text(
        json.dumps(dict(traffic, width=1280, height=720, focal=1100.0)))
    (root / "perfbench/metrics/frames_seen.py").write_text(
        "def read(ctx):\n    return ctx['counts']['frames']\n")
    (root / "perfbench/limits/base84_wide.video720.json").write_text(
        json.dumps({"mean_abs": {"limit": 0.5}}))
    # the new entries
    bench["configs"].append(dict(bench["configs"][0], name="base84_wide",
                                 file="perfbench/configs/base84_wide.json"))
    bench["workloads"].append({"name": "base84_wide.video720", "config": "base84_wide",
                               "traffic": "video720", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "frame_ms", "workloads": ["base84_wide.video720"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(root)
    assert all(after[k] == v for k, v in before.items()), "an existing file changed"
    new = spec.load_benchmark(root)
    cell = spec.find_cell(new, "base84_wide.video720")
    assert spec.load_config(new, cell["config"], root)["rgb_network"]["n_neurons"] == 128
    assert spec.load_traffic(cell["traffic"], root)["width"] == 1280
    assert [m["name"] for m in spec.metrics_of(new, cell["name"], True)] == ["frames_seen"]
    assert spec.metric_reader("frames_seen", root)({"counts": {"frames": 7}}) == 7
    assert callable(spec.kind_module("video", root).run)
