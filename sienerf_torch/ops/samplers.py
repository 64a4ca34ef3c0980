"""Low-discrepancy and stratified samplers (port of the JAX package's
ops/samplers.py): Halton and Sobol points for the image trainer's
coordinate samplers, subpixel offsets, stratified jitter and the Fibonacci
sphere of the ray-stab signed distance.  Halton accumulates in f32 digit
by digit and Sobol XORs uint32 direction numbers, as the reference
does."""

from __future__ import annotations

import numpy as np
import torch


def halton(index: int, base: int) -> np.float32:
    """Radical inverse of `index` in `base`, accumulated in f32 digit by
    digit as the reference does."""
    return np.float32(_halton_t(torch.tensor([int(index)]), base)[0])


def _halton_t(index: torch.Tensor, base: int) -> torch.Tensor:
    n_digits = int(np.ceil(np.log(2 ** 31) / np.log(base)))
    result = torch.zeros(index.shape, dtype=torch.float32, device=index.device)
    f = 1.0
    i = index.to(torch.int64)
    for _ in range(n_digits):
        f = f / base
        result = result + float(np.float32(f)) * (i % base).float()
        i = i // base
    return result


def ld_pixel_offset(spp: int) -> np.ndarray:
    """Per-pass low-discrepancy subpixel offset in [0, 1)^2."""
    h = np.asarray([halton(spp + 1, 2), halton(spp + 1, 3)], np.float32)
    return h % np.float32(1.0)


def halton_2d(indices):
    """(N,) int indices -> (N, 2) f32 Halton points in bases 2 and 3: a
    tensor on the indices' device for a tensor, else a numpy array."""
    idx = indices if isinstance(indices, torch.Tensor) \
        else torch.from_numpy(np.asarray(indices, np.int64).reshape(-1))
    out = torch.stack([_halton_t(idx, 2), _halton_t(idx, 3)], dim=-1)
    return out if isinstance(indices, torch.Tensor) else out.numpy()


def _sobol_directions(n_bits: int = 32) -> np.ndarray:
    """Direction numbers of the first two Sobol dimensions, (2, n_bits)."""
    v0 = np.array([1 << (31 - i) for i in range(n_bits)], np.uint32)  # van der Corput
    v1 = np.zeros(n_bits, np.uint32)  # x^2 + x + 1
    v1[0] = 1 << 31
    for i in range(1, n_bits):
        v1[i] = v1[i - 1] ^ (v1[i - 1] >> 1)
    return np.stack([v0, v1])


_SOBOL_DIRS = _sobol_directions()


def sobol_2d(indices: torch.Tensor) -> torch.Tensor:
    """The first two Sobol dimensions of integer sample indices -> (N, 2)
    f32.  The uint32 words are held in int64 (torch's uint32 arithmetic is
    incomplete); the XORs and the final scaling give the reference's
    values."""
    i = indices.to(torch.int64) & 0xFFFFFFFF
    out = []
    for d in range(2):
        acc = torch.zeros_like(i)
        for b in range(32):
            bit = (i >> b) & 1
            acc = acc ^ (bit * int(_SOBOL_DIRS[d, b]))
        # uint32 -> f32 rounds to nearest, as XLA's convert does
        out.append(acc.to(torch.float32) * (1.0 / 4294967296.0))
    return torch.stack(out, dim=-1)


def stratified_2d(n: int, generator: torch.Generator, grid: int | None = None,
                  device=None) -> torch.Tensor:
    """n stratified jittered samples in [0,1]^2 over a ~sqrt(n) grid."""
    if grid is None:
        grid = int(np.floor(np.sqrt(n)))
    idx = torch.arange(n, device=device)
    cx = (idx % grid).float()
    cy = ((idx // grid) % grid).float()
    jitter = torch.rand((n, 2), generator=generator, device=device)
    return torch.stack([(cx + jitter[:, 0]) / grid, (cy + jitter[:, 1]) / grid], dim=-1)


def fibonacci_sphere_dirs(n: int) -> np.ndarray:
    """n near-uniform unit directions on the sphere (float64 math, f32
    out), for ray-stab signed-distance queries."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + np.sqrt(5.0)) * i
    return np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi), np.cos(phi)],
                    axis=-1).astype(np.float32)
