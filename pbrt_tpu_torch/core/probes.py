"""Observability: profiler scopes + event counters.

Port of pbrt_tpu/core/probes.py (reference core/probes.{h,cpp}): named
scopes around render phases, visible in torch.profiler traces, and a
small host counter registry the render driver ticks per phase (tiles
rendered, camera samples), printed at WorldEnd under --verbose like
ProbesPrint (reference core/probes.cpp:163-199).
"""
from __future__ import annotations

import contextlib
import sys
import threading
from collections import defaultdict

_counters = defaultdict(int)
_lock = threading.Lock()


def count(name: str, n: int = 1):
    with _lock:
        _counters[name] += int(n)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def reset():
    with _lock:
        _counters.clear()


def print_counters():
    """reference ProbesPrint (core/probes.cpp:163-199)."""
    snap = counters()
    if not snap:
        return
    print("Statistics:", file=sys.stderr)
    for k in sorted(snap):
        print(f"    {k:<40s} {snap[k]:>14,d}", file=sys.stderr)


@contextlib.contextmanager
def scope(name: str):
    """Named profiler scope (shows up in torch.profiler traces)."""
    import torch

    with torch.profiler.record_function(name):
        yield
