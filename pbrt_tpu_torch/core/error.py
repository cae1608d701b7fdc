"""Info/Warning/Error/Severe reporting channel (reference core/error.cpp).

Severe raises instead of abort(); --quiet/--verbose gate the rest.
"""
from __future__ import annotations

import sys

quiet = False
verbose = False


class PbrtError(RuntimeError):
    pass


def info(msg: str):
    if verbose and not quiet:
        print(f"pbrt_tpu_torch: {msg}", file=sys.stderr)


def warning(msg: str):
    if not quiet:
        print(f"Warning: {msg}", file=sys.stderr)


def error(msg: str):
    print(f"Error: {msg}", file=sys.stderr)


def severe(msg: str):
    raise PbrtError(msg)


def progress(title: str, done: int, total: int, t_start: float):
    """Minimal ProgressReporter analog (reference core/progressreporter
    .cpp): one updating line with elapsed seconds."""
    if quiet:
        return
    import time

    elapsed = time.time() - t_start
    width = 40
    filled = int(width * done / max(total, 1))
    bar = "+" * filled + " " * (width - filled)
    end = "\n" if done >= total else "\r"
    print(f"\r{title}: [{bar}] ({elapsed:.1f}s)", end=end, file=sys.stderr)
