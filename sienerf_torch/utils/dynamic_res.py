"""Dynamic render resolution and the foveation warp (port of the JAX
package's utils/dynamic_res.py).

- DynamicResController: scales the render resolution by
  sqrt(target_ms / measured_ms), clamped to [1/16, 1], and moves only when
  the ratio leaves a +-20 % band (the reference's dynamic resolution).
- Foveation: a symmetric piecewise-quadratic warp per axis that puts
  `density` times more render samples at `center` (slope 1/density there,
  the endpoints fixed); warp maps display space to render space, unwarp
  back, both [0, 1] -> [0, 1], in float64 numpy."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class DynamicResController:
    target_ms: float = 33.3  # ~30 fps
    factor: float = 1.0
    min_factor: float = 1.0 / 16.0
    max_factor: float = 1.0
    hysteresis: float = 0.2

    def update(self, measured_ms: float) -> float:
        if measured_ms <= 0:
            return self.factor
        ratio = self.target_ms / measured_ms
        if ratio > 1.0 + self.hysteresis or ratio < 1.0 - self.hysteresis:
            new = self.factor * float(np.sqrt(ratio))
            self.factor = float(np.clip(new, self.min_factor, self.max_factor))
        return self.factor

    def resolution(self, full_w: int, full_h: int) -> tuple[int, int]:
        w = max(16, int(round(full_w * self.factor / 16)) * 16)
        h = max(16, int(round(full_h * self.factor / 16)) * 16)
        return min(w, full_w), min(h, full_h)


@dataclass(frozen=True)
class Foveation:
    """Symmetric per-axis piecewise-quadratic warp: each side of `center`
    maps its length y to s*y + a*y^2 with s = 1/density (the slope at the
    focus) and a chosen so that the side's end stays fixed."""

    density: float = 1.0
    center: float = 0.5

    def _sides(self):
        s = 1.0 / max(self.density, 1e-6)
        c = max(min(self.center, 1.0 - 1e-6), 1e-6)
        a_l = (1.0 - s) / c
        a_r = (1.0 - s) / (1.0 - c)
        return s, c, a_l, a_r

    def unwarp(self, t):
        """Render-space t -> display space."""
        if self.density <= 1.0:
            return t
        t = np.asarray(t, np.float64)
        s, c, a_l, a_r = self._sides()
        yl = c - t
        left = c - (s * yl + a_l * yl * yl)
        yr = t - c
        right = c + (s * yr + a_r * yr * yr)
        return np.where(t < c, left, right)

    def warp(self, u):
        """Display-space u -> render space (the inverse of unwarp)."""
        if self.density <= 1.0:
            return u
        u = np.asarray(u, np.float64)
        s, c, a_l, a_r = self._sides()

        def inv(q, a):
            # the root y >= 0 of a*y^2 + s*y - q = 0
            disc = np.maximum(s * s + 4 * a * q, 0.0)
            return np.where(np.abs(a) > 1e-12, (-s + np.sqrt(disc)) / (2 * a + 1e-30),
                            q / max(s, 1e-12))

        left = c - inv(c - u, a_l)
        right = c + inv(u - c, a_r)
        return np.where(u < c, left, right)
