"""Build and load the package's CUDA kernels.

Each `sienerf_torch/csrc/<name>.cu` has a plain C interface and compiles
with nvcc into `csrc/build/lib<name>.so` (Hopper, sm_90a), loaded with
ctypes.  A library is built at first use, or again when its source is
newer; `build()` compiles several sources at once, one nvcc each.  Nothing
is built when a module is imported, so the CPU-only tests import freely.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
KERNEL_SOURCES = ("shade", "sweep", "gather", "bvh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return nvcc


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return not lib.exists() or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime


def build(names=KERNEL_SOURCES, force: bool = False) -> dict[str, str]:
    """Compile the named sources in parallel -> {name: nvcc/ptxas report}.
    Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        if not (force or _stale(name)):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if code != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{prefix} kernel launch failed: "
                           f"{fn(code).decode()} (cudaError {code})")
