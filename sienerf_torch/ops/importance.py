"""Error-map importance sampling of training rays (port of the JAX
package's ops/importance.py).

Each training image has a low-resolution map (EH, EW) of the loss its rays
had.  Every step decays the maps and adds the step's per-ray losses at
their pixels (`splat_errors`); after a warm-up, rays are drawn with
probability proportional to the map plus a uniform floor
(`sample_error_map`), by inverse CDFs over images, rows and columns found
by dense comparison.  The sampler takes its uniforms as arguments
(`draw_error_map_uniforms`), so that a caller can hand in another
package's draws.
"""

from __future__ import annotations

import numpy as np
import torch

from sienerf_torch.ops.fixed_order import fixed_cumsum, segment_sum_sorted
from sienerf_torch.parallel.mesh import all_sum


def init_error_map(n_images: int, res: int = 32, device=None) -> dict:
    return {
        "error": torch.full((n_images, res, res), 1.0, dtype=torch.float32, device=device),
        # a slow decay (half-life ~1400 steps): texels that stop being drawn
        # must not fade to zero before they can be drawn again
        "decay": float(np.float32(0.9995)),
    }


def splat_errors(emap: dict, img_idx: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                 losses: torch.Tensor, mesh=None) -> dict:
    """Decay the maps and add each ray's loss at its (image, u, v).  With a
    mesh (parallel/mesh.py) every rank splats its own rays and the additive
    deltas are summed over the ranks, in rank order, before the decayed
    accumulation, so that the map stays the same on every rank."""
    n_img, eh, ew = emap["error"].shape
    ex = torch.clamp((u * ew).to(torch.int64), max=ew - 1)
    ey = torch.clamp((v * eh).to(torch.int64), max=eh - 1)
    flat = (img_idx.to(torch.int64) * eh + ey) * ew + ex
    # summed per texel in a fixed order: one seed, one map on the card too
    sflat, order = torch.sort(flat, stable=True)
    add = segment_sum_sorted(losses.float()[order], sflat, n_img * eh * ew)
    if mesh is not None:
        add = all_sum(add, mesh)
    err = emap["error"].reshape(-1) * emap["decay"] + add
    return {**emap, "error": err.reshape(n_img, eh, ew)}


def _inverse_cdf(cdf: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cdf (..., K) inclusive and normalised, u (...,) -> index (...,)."""
    return (u[..., None] >= cdf).sum(dim=-1)


def draw_error_map_uniforms(n_rays: int, generator: torch.Generator, device=None) -> dict:
    """The uniforms of sample_error_map: one each for the image, the row
    and the column CDF, and a subpixel jitter (n, 2)."""
    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    return {"u_img": rand(n_rays), "u_row": rand(n_rays), "u_col": rand(n_rays),
            "jitter": rand(n_rays, 2)}


def sample_error_map(emap: dict, draws: dict, uniform_frac: float = 0.25):
    """Draw (img_idx, u, v) for each ray in proportion to the accumulated
    error.  A `uniform_frac` share of the mean is added to every texel, so
    every pixel keeps being drawn: a pure CDF sampler collapses onto the
    pixels it happens to draw first."""
    err = torch.clamp(emap["error"], min=1e-8)
    err = err + uniform_frac * err.mean()
    n_img, eh, ew = err.shape

    per_img = err.sum(dim=(1, 2))
    cdf_img = fixed_cumsum(per_img) / per_img.sum()
    img_idx = torch.clamp(_inverse_cdf(cdf_img, draws["u_img"]), max=n_img - 1)

    rows = err.sum(dim=2)
    cdf_row = torch.cumsum(rows, dim=1) / rows.sum(dim=1, keepdim=True)
    ey = torch.clamp(_inverse_cdf(cdf_row[img_idx], draws["u_row"]), max=eh - 1)

    cdf_col = torch.cumsum(err, dim=2) / torch.clamp(err.sum(dim=2, keepdim=True), min=1e-12)
    flat_cdf = cdf_col.reshape(n_img * eh, ew)
    ex = torch.clamp(_inverse_cdf(flat_cdf[img_idx * eh + ey], draws["u_col"]), max=ew - 1)

    jitter = draws["jitter"]
    u = (ex.float() + jitter[:, 0]) / ew
    v = (ey.float() + jitter[:, 1]) / eh
    return img_idx, u, v
