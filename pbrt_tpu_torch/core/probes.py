"""Observability: event counters and timed spans.

Port of pbrt_tpu/core/probes.py (reference core/probes.{h,cpp}): a small
host counter registry the render driver ticks per phase (tiles rendered,
camera samples), and named scopes around the render loop's layers,
printed at WorldEnd under --verbose like ProbesPrint (reference
core/probes.cpp:163-199).

A scope is a no-op until `enable(True)`: it then records a span
(name, start_ns, end_ns, parent) stamped with `time.time_ns()`, the
clock torch.profiler stamps its events with, so that spans line up with
the card's rows of a profile that records the device alone. `parent` is
the index in `spans()` of the span that encloses it on the same thread
(-1 at a root). A span also enters `torch.profiler.record_function`, so
a profiler trace carries the same names. A span never reads a device
value: tracing adds no host sync and no device operation. Each frame's
root is `render/frame`; a `sync/<site>` span wraps one call that waits
on the card.
"""
from __future__ import annotations

import functools
import sys
import threading
import time
from collections import defaultdict
from typing import NamedTuple

_counters = defaultdict(int)
_lock = threading.Lock()
_spans: list = []            # [name, start_ns, end_ns (None while open), parent]
_local = threading.local()   # .stack: indices of this thread's open spans
_on = False


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int


def count(name: str, n: int = 1):
    with _lock:
        _counters[name] += int(n)


def counters() -> dict:
    with _lock:
        return dict(_counters)


def enable(on: bool):
    """Turn span recording on or off (off at import)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def spans() -> list:
    """The spans recorded since the last reset, as Span rows in the
    order they opened; one still open reads end_ns None."""
    with _lock:
        return [Span(*s) for s in _spans]


def reset():
    with _lock:
        _counters.clear()
        _spans.clear()
    _local.stack = []


def span_table(rows=None) -> dict:
    """name -> (count, total seconds, self seconds) of closed spans. A
    span's self seconds are its duration less its children's (a
    thread's children run one after another)."""
    rows = spans() if rows is None else rows
    child_ns = defaultdict(int)
    for s in rows:
        if s.parent >= 0 and s.end_ns is not None:
            child_ns[s.parent] += s.end_ns - s.start_ns
    out = {}
    for i, s in enumerate(rows):
        if s.end_ns is None:
            continue
        n, tot, own = out.get(s.name, (0, 0.0, 0.0))
        dur = s.end_ns - s.start_ns
        out[s.name] = (n + 1, tot + dur * 1e-9, own + (dur - child_ns[i]) * 1e-9)
    return out


def print_counters():
    """reference ProbesPrint (core/probes.cpp:163-199), then one row per
    span name: count, total and self seconds."""
    snap = counters()
    table = span_table()
    if not snap and not table:
        return
    print("Statistics:", file=sys.stderr)
    for k in sorted(snap):
        print(f"    {k:<40s} {snap[k]:>14,d}", file=sys.stderr)
    if table:
        print(f"    {'span':<40s} {'count':>14s} {'total s':>12s} {'self s':>12s}",
              file=sys.stderr)
    for k in sorted(table):
        n, tot, own = table[k]
        print(f"    {k:<40s} {n:>14,d} {tot:>12.6f} {own:>12.6f}", file=sys.stderr)


class _NoScope:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SCOPE = _NoScope()


class _Scope:
    __slots__ = ("name", "rec", "rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        import torch

        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.rf = torch.profiler.record_function(self.name)
        rec = self.rec = [self.name, None, None, stack[-1] if stack else -1]
        # the clock is read right before the profiler's event opens, and
        # the span's bookkeeping comes after: the span starts no later
        # than its event, and as close to it as the process allows
        rec[1] = time.time_ns()
        self.rf.__enter__()
        with _lock:
            stack.append(len(_spans))
            _spans.append(rec)

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec[2] = time.time_ns()
        stack = _local.stack
        if stack:
            stack.pop()
        return False


def scope(name: str):
    """A span named `name` while tracing is on; else one shared no-op
    context that reads no clock."""
    return _Scope(name) if _on else _NO_SCOPE


def spanned(name: str):
    """Decorator: the whole call is a span named `name` while tracing is
    on; else the function runs as it is."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Scope(name):
                return fn(*args, **kwargs)
        return call
    return wrap
