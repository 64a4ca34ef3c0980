"""The plain reference of a one-pass slab-sweep frame (spp 1), as a viewer
renders it: every ray through its pixel's centre and every sample plane at
its slab (no subpixel offset, no slab phase).  reference/sweep.py's shade,
geometry, composite and warp; its `render` jitters even a single pass
(pass 0's Halton offset and a half-slab phase), as the program does only
from spp 2 on.  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import sweep as ref_sweep

CENTRE = (0.5, 0.5)


def render(rows, scale, rgb_w, cam, focal, width: int, height: int, resolution: int,
           n_cascades: int, precision: str = "bf16", stats: list | None = None) -> torch.Tensor:
    """One frame -> (H, W, 4) f32 rgba; with `stats` (a list) the pass's
    composite counts are appended."""
    dev = rows.device
    origin = torch.as_tensor(np.asarray(cam, np.float32)[:, 3], device=dev)
    vol = ref_sweep.shade(rows, scale, origin, rgb_w, resolution, n_cascades, precision)
    g = ref_sweep.geometry(cam, focal, width, height, CENTRE, dev)
    st = {} if stats is not None else None
    C, op, _, _ = ref_sweep.composite(ref_sweep.orient(vol, g), g["o_c"], g["eb"], g["ec"],
                                      np.float32(0.0), resolution, n_cascades, st)
    if stats is not None:
        stats.append(dict(st, axis=g["axis"]))
    out = ref_sweep.warp(torch.cat([C, op[..., None]], dim=-1), g)
    good = g["good"]
    rgb = torch.where(good[:, None], out[:, :3], 0.0)
    a = torch.where(good, out[:, 3].clamp(0.0, 1.0), 0.0)
    return torch.cat([rgb, a[:, None]], dim=-1).reshape(height, width, 4)
