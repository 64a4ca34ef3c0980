"""The general generator: a traffic file's parameters and a seed -> the
inputs a run sends.  The same seed gives the same inputs.

Camera paths ("path" in a traffic file):
- "fibonacci": n cameras on a Fibonacci sphere of `radius` around the
  cube's centre (0.5, 0.5, 0.5), each looking at it (NGP camera matrices,
  up +y).  The run sends them in the order i -> (start + i * stride) mod n,
  so that any run of consecutive frames samples the whole sphere; the seed
  picks `start`.  Every seed sends the same set of cameras.
"""

from __future__ import annotations

import math

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the seed (any non-negative int)."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """NGP-convention (3, 4) camera matrix: columns right, down, forward,
    eye."""
    eye = np.asarray(eye, np.float32)
    fwd = np.asarray(target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float32))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    return np.stack([right, down, fwd, eye], axis=1).astype(np.float32)


def fibonacci_cameras(n: int, radius: float) -> list[np.ndarray]:
    c = np.full(3, 0.5)
    golden = math.pi * (3.0 - math.sqrt(5.0))
    cams = []
    for i in range(n):
        y = 1.0 - 2.0 * (i + 0.5) / n
        r = math.sqrt(1.0 - y * y)
        eye = c + radius * np.array([r * math.cos(golden * i), y, r * math.sin(golden * i)])
        cams.append(look_at(eye, c))
    return cams


def sweep_axis(cam: np.ndarray) -> tuple[int, bool]:
    """The dominant axis of a camera's forward ray, and whether it points
    down that axis (the sweep's axis and flip)."""
    f = np.asarray(cam, np.float32)[:, 2]
    axis = int(np.argmax(np.abs(f)))
    return axis, bool(f[axis] < 0)


def camera_path(path: dict, seed: int) -> list[np.ndarray]:
    """A traffic file's "path" -> the cameras in the order the run sends
    them (one cycle; the run repeats it)."""
    if path["shape"] != "fibonacci":
        raise ValueError(f"unknown camera path {path['shape']!r}")
    n, stride = int(path["n_cameras"]), int(path["stride"])
    if math.gcd(n, stride) != 1:
        raise ValueError("the path's stride must be coprime to its camera count")
    cams = fibonacci_cameras(n, float(path["radius"]))
    start = int(rng(seed, 0).integers(n))
    return [cams[(start + i * stride) % n] for i in range(n)]


def check_sample(cams: list[np.ndarray], seed: int, per_axis: int) -> list[int]:
    """`per_axis` path positions for each sweep axis the path has, drawn
    from the seed: the frames the correctness check compares."""
    r = rng(seed, 1)
    out = []
    for axis in range(3):
        idx = [i for i, c in enumerate(cams) if sweep_axis(c)[0] == axis]
        if idx:
            out += sorted(r.choice(idx, size=min(per_axis, len(idx)), replace=False).tolist())
    return out
