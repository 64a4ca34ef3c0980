"""Minimal logging (port of the JAX package's utils/log.py, the reference's
tlog::info / success / warning / error): each line is the seconds since
import, the tag and the message; info and success go to stdout (or the
stream set with set_stream), warning and error to stderr."""

from __future__ import annotations

import sys
import time

_T0 = time.time()
_VERBOSE = True
_STREAM = None  # None: sys.stdout at emit time


def set_verbose(v: bool) -> None:
    global _VERBOSE
    _VERBOSE = v


def set_stream(stream) -> None:
    """Send info and success to `stream` (sys.stderr for a tool whose stdout
    carries a machine-read result)."""
    global _STREAM
    _STREAM = stream


def _emit(tag: str, msg: str, stream=None) -> None:
    if not _VERBOSE:
        return
    stream = stream or _STREAM or sys.stdout
    print(f"[{time.time() - _T0:8.2f}s] {tag:<7s} {msg}", file=stream, flush=True)


def info(msg: str) -> None:
    _emit("INFO", msg)


def success(msg: str) -> None:
    _emit("SUCCESS", msg)


def warning(msg: str) -> None:
    _emit("WARNING", msg, sys.stderr)


def error(msg: str) -> None:
    _emit("ERROR", msg, sys.stderr)
