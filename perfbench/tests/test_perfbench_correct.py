"""`correct` at a size a CPU test can hold: a sound run passes, and a run
whose timed path is broken underneath does not, nor does the control (the
reference in e4m3 put in the program's place).  These tests skip the
look for a card and drive the rest of a run on the CPU, where the program
takes its plain paths; the same numbers are compared with the cell's own
limits."""

from __future__ import annotations

import pytest
import torch

from perfbench.compare import judge, load_limits
from perfbench.control import control_numbers
from perfbench.run import run_cell

SMALL = {"width": 64, "height": 36, "spp": 2, "bake_resolution": 16,
         "path": {"n_cameras": 12, "stride": 5}}
BIG_SMALL = dict(SMALL, config={"encoding": {"log2_hashmap_size": 12}})
SIZES = {"base84.video1080": SMALL, "big.video1080": BIG_SMALL}
SEED = 2 ** 31 + 3


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run(cell):
    return run_cell(cell, SEED, 1.5, False, "cpu", {"platform": "cpu"}, overrides=SIZES[cell])


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_a_sound_run_is_correct(cell):
    line, numbers = _run(cell)
    assert line["correct"], numbers
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(load_limits(cell))


def _altered(rgba):
    """An answer altered where it is produced: a block of the frame."""
    out = rgba.clone()
    out[: rgba.shape[0] // 3, : rgba.shape[1] // 3, :3] += 0.25
    return out


def _stale():
    """A frame that returns the state it had: the previous frame again (an
    empty one first)."""
    prev = {}

    def fault(rgba):
        out = prev.get("rgba", torch.zeros_like(rgba))
        prev["rgba"] = rgba
        return out
    return fault


def _not_finite(rgba):
    return rgba.masked_fill(torch.zeros_like(rgba, dtype=torch.bool).index_fill(
        0, torch.tensor([0]), True), float("nan"))


@pytest.mark.parametrize("cell", sorted(SIZES))
@pytest.mark.parametrize("fault", ["altered", "stale", "half_the_passes", "not_finite"])
def test_a_broken_frame_is_not_correct(cell, fault, monkeypatch):
    from sienerf_torch.session import Session

    render = Session.render
    if fault == "half_the_passes":  # half of the passes left out, the mean over the rest
        def broken(self, *a, spp=1, **kw):
            return render(self, *a, spp=max(1, spp // 2), **kw)
    else:  # the frame broken where Session.render produces it
        hook = {"altered": _altered, "stale": _stale(), "not_finite": _not_finite}[fault]

        def broken(self, *a, **kw):
            return hook(render(self, *a, **kw))
    monkeypatch.setattr(Session, "render", broken)
    line, numbers = _run(cell)
    assert not line["correct"], (fault, numbers)


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_the_control_is_not_correct(cell):
    numbers = control_numbers(cell, SEED, "cpu", overrides=SIZES[cell])
    ok, checks = judge(numbers, load_limits(cell))
    assert not ok, checks
