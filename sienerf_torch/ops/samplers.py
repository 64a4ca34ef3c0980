"""Halton low-discrepancy points (port of the Halton part of the JAX
package's ops/samplers.py), on the host in float32: subpixel offsets and
the 2-D set the irradiance probes' multi-origin envmaps use."""

from __future__ import annotations

import numpy as np


def halton(index: int, base: int) -> np.float32:
    """Radical inverse of `index` in `base`, accumulated in f32 digit by
    digit as the reference does."""
    n_digits = int(np.ceil(np.log(2 ** 31) / np.log(base)))
    result = np.float32(0.0)
    f = 1.0
    i = int(index)
    for _ in range(n_digits):
        f = f / base
        result = np.float32(result + np.float32(f) * np.float32(i % base))
        i //= base
    return result


def ld_pixel_offset(spp: int) -> np.ndarray:
    """Per-pass low-discrepancy subpixel offset in [0, 1)^2."""
    h = np.asarray([halton(spp + 1, 2), halton(spp + 1, 3)], np.float32)
    return h % np.float32(1.0)


def halton_2d(indices) -> np.ndarray:
    """(N,) int indices -> (N, 2) f32 Halton points in bases 2 and 3."""
    return np.asarray([[halton(i, 2), halton(i, 3)] for i in np.asarray(indices).reshape(-1)],
                      np.float32).reshape(-1, 2)
