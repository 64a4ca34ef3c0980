"""Timers smoothed by an exponential moving average with a half-life in
seconds (port of the JAX package's utils/timers.py; the reference's `Ema`
behind its training, render and frame ms displays)."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class Ema:
    """Exponential moving average with a half-life in seconds: a sample
    `dt` seconds after the last one keeps 0.5 ** (dt / half_life_s) of the
    old value."""

    half_life_s: float = 1.0
    value: float = 0.0
    _last_t: float = field(default=0.0, repr=False)
    _initialized: bool = field(default=False, repr=False)

    def update(self, sample: float, now: float | None = None) -> float:
        now = time.monotonic() if now is None else now
        if not self._initialized:
            self.value = sample
            self._initialized = True
        else:
            dt = max(now - self._last_t, 0.0)
            alpha = 0.5 ** (dt / self.half_life_s) if self.half_life_s > 0 else 0.0
            self.value = alpha * self.value + (1.0 - alpha) * sample
        self._last_t = now
        return self.value


class PhaseTimers:
    """Named EMA timers of ms: `with timers.phase("train"): ...`."""

    def __init__(self, half_life_s: float = 1.0):
        self.half_life_s = half_life_s
        self.timers: dict[str, Ema] = {}

    def phase(self, name: str):
        timers = self.timers
        hl = self.half_life_s

        class _Ctx:
            def __enter__(self):
                self.t0 = time.monotonic()
                return self

            def __exit__(self, *exc):
                dt_ms = (time.monotonic() - self.t0) * 1e3
                timers.setdefault(name, Ema(hl)).update(dt_ms)
                return False

        return _Ctx()

    def ms(self, name: str) -> float:
        t = self.timers.get(name)
        return t.value if t else math.nan

    def summary(self) -> str:
        return " ".join(f"{k}={v.value:.2f}ms" for k, v in self.timers.items())
