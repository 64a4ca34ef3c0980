"""Axis-aligned bounding box (port of the JAX package's utils/bbox.py)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sienerf_torch.utils.device_inputs import constant


@dataclass(frozen=True)
class BoundingBox:
    """Static AABB; min/max are length-3 float32 numpy arrays."""

    min: np.ndarray
    max: np.ndarray

    @staticmethod
    def unit() -> "BoundingBox":
        return BoundingBox(np.zeros(3, np.float32), np.ones(3, np.float32))

    @staticmethod
    def from_scale(aabb_scale: float) -> "BoundingBox":
        """NGP convention: box of side `aabb_scale` centred at (0.5, 0.5, 0.5)."""
        c = np.full(3, 0.5, np.float32)
        h = np.full(3, 0.5 * aabb_scale, np.float32)
        return BoundingBox(c - h, c + h)

    @property
    def diag(self) -> np.ndarray:
        return self.max - self.min

    def enlarged(self, other: "BoundingBox") -> "BoundingBox":
        return BoundingBox(np.minimum(self.min, other.min), np.maximum(self.max, other.max))

    def inflated(self, amount: float) -> "BoundingBox":
        return BoundingBox(self.min - amount, self.max + amount)

    def ray_intersect(self, origin: torch.Tensor, direction: torch.Tensor,
                      eps: float = 1e-12):
        """Slab test -> (tmin, tmax); a miss has tmin > tmax."""
        lo = constant(self.min, origin.device)
        hi = constant(self.max, origin.device)
        tiny = torch.where(direction < 0, -eps, eps).to(direction.dtype)
        inv_d = 1.0 / torch.where(direction.abs() < eps, tiny, direction)
        t0 = (lo - origin) * inv_d
        t1 = (hi - origin) * inv_d
        tmin = torch.minimum(t0, t1).amax(dim=-1)
        tmax = torch.maximum(t0, t1).amin(dim=-1)
        return tmin, tmax
