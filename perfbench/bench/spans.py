"""What the per-layer readers of the program's own spans read.

The program records spans at its layer boundaries when its tracing is
on (pbrt_tpu_torch/core/probes.py: `enable`, `spans`, `reset`), stamped
with `time.time_ns()`, the clock torch.profiler stamps its events with.
The traced frames render again twice, each result cached on the run:

- replay A, spans on and no profiler, at close to the untraced pace: the
  spans' counts and host seconds (`host`);
- replay B, spans on inside a profile that records the device alone:
  each idle gap between the union of the device's rows is named by the
  innermost span open at its middle, "outside" where none is (`idle`).

Tracing is off again when either returns. A program without spans (one
whose probes lack `enable`) gives None, and so do its readers.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from perfbench.bench import trace

FRAME = "render/frame"
OUTSIDE = "outside"


@dataclass
class HostSpans:
    frames: int
    table: dict                  # name -> (count, total s, self s)

    def count(self, prefix: str) -> int:
        """Spans whose name is `prefix` or starts with it."""
        return sum(n for k, (n, _, _) in self.table.items() if k.startswith(prefix))

    def seconds(self, prefix: str) -> float:
        return sum(s for k, (_, s, _) in self.table.items() if k.startswith(prefix))


@dataclass
class IdleSpans:
    idle_s: float                                   # every idle second of the window
    by_span: dict = field(default_factory=dict)     # innermost span -> idle seconds
    spans: list = field(default_factory=list)       # the replay's spans
    device: list = field(default_factory=list)      # (start, end, name) of its device rows

    def share(self, *names) -> float:
        return 100.0 * sum(self.by_span.get(n, 0.0) for n in names) / self.idle_s


def on_card(run) -> bool:
    """Whether the run's frames rendered on a card: a sync is a wait on
    one, so the sync readers read only there."""
    device = getattr(getattr(run, "port", None), "device", None)
    return getattr(device, "type", None) == "cuda"


def program_probes():
    try:
        from pbrt_tpu_torch.core import probes
    except ImportError:
        return None
    if not all(hasattr(probes, a) for a in ("enable", "spans", "reset", "span_table")):
        return None
    return probes


def with_spans(probes, fn):
    """fn() with the program's spans on -> (fn's result, the spans)."""
    probes.reset()
    probes.enable(True)
    try:
        out = fn()
    finally:
        probes.enable(False)
    rows = probes.spans()
    probes.reset()
    return out, rows


def host(run):
    """Replay A (cached on the run) -> HostSpans, or None."""
    if not hasattr(run, "spans_host"):
        probes = program_probes()
        run.spans_host = None
        if probes is not None:
            _, rows = with_spans(probes, run.replay)
            table = probes.span_table(rows)
            frames = table.get(FRAME, (0, 0.0, 0.0))[0]
            if frames:
                run.spans_host = HostSpans(frames, table)
    return run.spans_host


def idle(run):
    """Replay B (cached on the run) -> IdleSpans, or None (also without
    a card: the device's rows are the card's)."""
    if not hasattr(run, "spans_idle"):
        run.spans_idle = None
        probes = program_probes()
        import torch

        if probes is not None and torch.cuda.is_available():
            from torch.profiler import ProfilerActivity

            def replay():
                with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run.replay()
                return prof.profiler.kineto_results.events()

            events, rows = with_spans(probes, replay)
            run.spans_idle = reduce_idle(events, rows)
    return run.spans_idle


def reduce_idle(events, rows):
    """A device-only trace and the spans of the same frames -> IdleSpans
    over the window from the first frame's start to the last one's end,
    or None. The spans' own annotations on the device's timeline are
    not rows."""
    names = {s.name for s in rows}
    frames = [s for s in rows if s.name == FRAME and s.end_ns is not None]
    dev = sorted(r for r in trace._device_rows(events) if r[2] not in names)
    if not frames or not dev:
        return None
    w0, w1 = min(s.start_ns for s in frames), max(s.end_ns for s in frames)
    dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev if b > w0 and a < w1]
    _, gaps, _ = trace._union(dev, w0, w1)
    by_span = name_gaps(gaps, rows)
    return IdleSpans(idle_s=sum(by_span.values()), by_span=by_span, spans=rows, device=dev)


def name_gaps(gaps, rows) -> dict:
    """Idle seconds by the innermost span open at each gap's middle (the
    latest-started open one: a thread's spans nest, and a parent is
    recorded before its children), OUTSIDE where none is."""
    spans = sorted((s.start_ns, k, s.end_ns, s.name) for k, s in enumerate(rows)
                   if s.end_ns is not None)
    out = defaultdict(float)
    stack, i = [], 0
    for m, length in sorted(((g0 + g1) // 2, g1 - g0) for g0, g1 in gaps):
        while i < len(spans) and spans[i][0] <= m:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < m:
            stack.pop()
        out[stack[-1][3] if stack else OUTSIDE] += length * 1e-9
    return dict(out)
