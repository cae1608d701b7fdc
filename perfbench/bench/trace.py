"""Reduces torch.profiler traces of some frames to what the per-layer
metrics read. The traced frames render twice: once with the device's
activity alone recorded (the window's length, the union of device
activity in it, the device operations by name), and once with the
host's operations recorded too, which slows the host about twofold, for
the device's idle gaps named by what the host was doing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "perfbench.trace_window"
NAME_CHARS = 200   # kept of an operation's name: a templated kernel names its functor late


@dataclass
class TraceReport:
    window_s: float
    busy_s: float
    device_ops: int
    samples: int
    by_name: dict = field(default_factory=dict)     # device op -> [seconds, count]
    idle_by_host: dict = field(default_factory=dict)  # host op -> idle seconds

    def top_device_ops(self, n=10):
        rows = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return [[k, v[0]] for k, v in rows]

    def top_idle(self, n=10):
        rows = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in rows]


def _start_dur_ns(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return e.start_us() * 1000, e.duration_us() * 1000


def profile_device(render, frames, samples_per_frame: int, sync) -> TraceReport:
    """Render the frames under torch.profiler recording the device's
    activity alone, so that the frames keep close to their untraced pace,
    and reduce the trace: the window is the host clock's, from a
    synchronised start to a synchronised end; busy time is the union of
    the device's operations in it."""
    import time

    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for f in frames:
            render(f)
        sync()
        window_s = time.perf_counter() - t0
    return reduce_device(prof.profiler.kineto_results.events(), window_s,
                         samples_per_frame * len(frames))


def profile_host(render, frames, sync) -> TraceReport:
    """Render the frames under torch.profiler recording host and device
    activity (a frame takes about twice as long), for what the host was
    doing in each of the device's idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            for f in frames:
                render(f)
            sync()
    return reduce_events(prof.profiler.kineto_results.events(), 0)


def _is_annotation(e):
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def _device_rows(events):
    """(start, end, name) of the device's operations; the window's own
    annotation, mirrored on the device's timeline, is not one."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if (e.device_type() == DeviceType.CUDA and e.name() != WINDOW
                and not _is_annotation(e)):
            s, d = _start_dur_ns(e)
            out.append((s, s + d, e.name()))
    return out


def _union(dev, w0, w1):
    """-> (busy ns, idle gaps [(start, end)], {name: [seconds, count]}) of
    device rows (start, end, name) sorted by start and clipped to [w0, w1]."""
    by_name = defaultdict(lambda: [0.0, 0])
    busy, gaps = 0, []
    cur0, cur1 = None, None
    for a, b, n in dev:
        by_name[n[:NAME_CHARS]][0] += (b - a) * 1e-9
        by_name[n[:NAME_CHARS]][1] += 1
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
                gaps.append((cur1, a))
            elif a > w0:
                gaps.append((w0, a))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    if cur1 is not None:
        busy += cur1 - cur0
        if cur1 < w1:
            gaps.append((cur1, w1))
    else:
        gaps.append((w0, w1))
    return busy, gaps, dict(by_name)


def reduce_device(events, window_s: float, samples: int) -> TraceReport:
    """A device-only trace over a window of `window_s` host seconds."""
    dev = sorted(_device_rows(events))
    lo = dev[0][0] if dev else 0
    busy, _, by_name = _union(dev, lo, max([b for _, b, _ in dev], default=lo))
    return TraceReport(window_s=window_s, busy_s=busy * 1e-9, device_ops=len(dev),
                       samples=samples, by_name=by_name)


def reduce_events(events, samples: int) -> TraceReport:
    """A host and device trace, over its WINDOW span; idle gaps named by
    the host's operations."""
    from torch.autograd import DeviceType

    win, host = None, []
    for e in events:
        if e.device_type() != DeviceType.CUDA and e.name() == WINDOW:
            s, d = _start_dur_ns(e)
            win = (s, s + d, e.start_thread_id())
        elif e.device_type() != DeviceType.CUDA:
            s, d = _start_dur_ns(e)
            host.append((s, s + d, e.name(), e.start_thread_id()))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1, thread = win
    dev = sorted((max(a, w0), min(b, w1), n) for a, b, n in _device_rows(events)
                 if b > w0 and a < w1)
    busy, gaps, by_name = _union(dev, w0, w1)
    return TraceReport(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device_ops=len(dev),
                       samples=samples, by_name=by_name,
                       idle_by_host=_name_gaps(gaps, host, thread))


def _name_gaps(gaps, host, thread):
    """Each idle gap is named by the innermost host operation of the
    window's thread that spans its middle, else by the last one that
    ended before it ("after <op>"); gap seconds are summed by name."""
    ops = sorted((a, b, n) for a, b, n, t in host if t == thread)
    ends = sorted((b, n) for a, b, n in ops)
    end_times = [b for b, _ in ends]
    mids = sorted(((g0 + g1) // 2, g1 - g0) for g0, g1 in gaps)
    out = defaultdict(float)
    stack, i = [], 0
    for m, length in mids:
        while i < len(ops) and ops[i][0] <= m:
            stack.append(ops[i])
            i += 1
        inner = None
        for a, b, n in reversed(stack):
            if b >= m:
                inner = n
                break
        stack = [op for op in stack if op[1] >= m]
        if inner is None:
            j = bisect.bisect_right(end_times, m) - 1
            inner = f"after {ends[j][1]}" if j >= 0 else "before any host op"
        out[inner[:NAME_CHARS]] += length * 1e-9
    return dict(out)
