"""The program's kernel names, as the device trace shows them (templated
kernels carry their arguments after the name)."""

from __future__ import annotations

import re

_K1 = re.compile(r"\bshade(_general|_wide)?_kernel\b")  # csrc/shade.cu
_K2 = re.compile(r"\bsweep_kernel\b")                     # csrc/sweep.cu


def is_k1(name: str) -> bool:
    return bool(_K1.search(name))


def is_k2(name: str) -> bool:
    return bool(_K2.search(name))
