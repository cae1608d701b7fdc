"""Observability: profiler scopes, traces + event counters.

Port of pbrt_tpu/core/probes.py (reference core/probes.{h,cpp}): named
scopes around render phases, visible in torch.profiler traces; a trace
started and stopped by name (start_trace / stop_trace, a torch.profiler
session of the CPU and, where there is one, the card, written into a
log directory as a Chrome trace); and a small host counter registry the
render driver ticks per phase (tiles rendered, camera samples), printed
at WorldEnd under --verbose like ProbesPrint (reference
core/probes.cpp:163-199).
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


_trace = None   # the profiler of the running start_trace session


def start_trace(logdir: str):
    """Start tracing the CPU and, where there is one, the card."""
    global _trace
    import torch

    with _lock:
        if _trace is not None:
            raise RuntimeError("a trace is already running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=acts, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
        prof.start()
        _trace = prof


def stop_trace():
    """Stop the running trace and write it into its logdir as a Chrome
    trace (<host>_<pid>.<ms>.pt.trace.json)."""
    global _trace
    with _lock:
        if _trace is None:
            raise RuntimeError("no trace is running")
        prof, _trace = _trace, None
    prof.stop()
