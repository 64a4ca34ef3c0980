"""The comparison that decides `correct`: numbers computed from what the
timed path produced and what the plain reference produced, each held to a
limit of its own from perfbench/limits/<cell>.json.

A limit file maps a number's name to {"limit": x, ...}: the number passes
when it is at most x.  Its other keys record the readings the limit was
set from.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from perfbench.spec import ROOT


def frame_numbers(pairs) -> dict:
    """[(program uint8 frame, reference uint8 frame)] -> `mean_abs`, the
    mean gap in 8-bit levels over every channel of every pixel of every
    pair, and `max_abs`, the largest.  No pair: both are infinite, which
    fails any limit."""
    if not pairs:
        return {"mean_abs": float("inf"), "max_abs": float("inf")}
    d = np.concatenate([np.abs(a.astype(np.int16) - b.astype(np.int16)).ravel()
                        for a, b in pairs])
    return {"mean_abs": float(d.mean()), "max_abs": float(d.max())}


def load_limits(cell: str, root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "perfbench" / "limits" / f"{cell}.json").read_text())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every limited number within its limit, {name: {"value",
    "limit"}}).  A number that is missing or not finite fails."""
    checks = {}
    ok = True
    for name, spec in limits.items():
        v = numbers.get(name, float("nan"))
        checks[name] = {"value": v, "limit": spec["limit"]}
        ok &= bool(np.isfinite(v) and v <= spec["limit"])
    return ok, checks
