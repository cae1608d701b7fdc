"""One run of one cell: set-up, the measured (or traced) window, the check.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from the process's start to the first
timed frame) loads the kernels, builds and compiles the scene and renders
one warm-up frame of the cell's shapes. With --trace 0 the window renders
frames one after another (a closed loop: one user waits for each frame)
until --seconds have passed, and the last line reports the cell's
end-to-end metrics. With --trace 1 the cell's `trace_frames` frames
render untraced and then under torch.profiler (bench/trace.py), and the
line reports its per-layer metrics, the device's busy time and a
breakdown. Either way the frames the window produced are then checked
against the configuration's plain reference, after the renderer's scene
is freed.

Everything that belongs to one configuration, cell or metric is in files
of its own, found by name (bench/loader.py): the harness names none.

A run needs the card: without CUDA it exits 2 and prints no result. It
runs a cell on one card; a cell that asks for more is refused (exit 3).
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback
from dataclasses import dataclass

import numpy as np

from perfbench.bench import check, traffic as traffic_mod
from perfbench.bench.loader import ROOT, CellError, load_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "pbrt_tpu"}


class NoCard(RuntimeError):
    pass


def since_process_start() -> float:
    """Seconds since this process was created (/proc), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclass
class Window:
    """What the end-to-end readers read: the frames the window completed,
    their camera samples, each frame's latency, the first frame's start
    and the last one's end (host clock), and the set-up's seconds."""
    frames: list
    samples: int
    frame_s: list
    t_first: float
    t_end: float
    setup_s: float


class Run:
    """What the per-layer readers read: set-up spans, the trace report,
    the host seconds of the traced frames rendered untraced before the
    traces (`untraced_s`), the renderer, and `replay()`, which renders
    the traced frames again for readers that count a layer's work."""

    def __init__(self, port, spans, trace_report=None, frames=()):
        self.port, self.spans, self.trace, self.frames = port, spans, trace_report, list(frames)
        self.untraced_s = None

    def replay(self) -> float:
        """Renders the traced frames again -> host seconds, synchronised."""
        self.port.sync()
        t0 = time.perf_counter()
        for f in self.frames:
            self.port.render(f)
        self.port.sync()
        return time.perf_counter() - t0


def setup(cell, device):
    from perfbench.bench.port import PortRenderer

    if device.startswith("cuda"):
        from pbrt_tpu_torch.ops.build import load_kernels

        load_kernels()
    port = PortRenderer(cell.builder, cell.config, cell.traffic, device)
    port.render(traffic_mod.warmup_frame(cell.traffic), one_tile=True)
    port.sync()
    return port


def timed_window(port, frames, seconds: float):
    """Frames one after another until `seconds` have passed -> (Window,
    images)."""
    done, images, lat = [], [], []
    setup_s = since_process_start()
    t_first = time.perf_counter()
    t_end = t_first
    for f in frames:
        t0 = time.perf_counter()
        images.append(port.render(f))
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        done.append(f)
        if t_end - t_first >= seconds:
            break
    return Window(done, len(done) * port.samples_per_frame, lat, t_first, t_end,
                  setup_s), images


def reference_for(cell, device, dtype=None):
    """The configuration's plain reference at the cell's film: a callable
    (frames, fi, x, y) -> linear RGB [N, 3]."""
    import torch

    return cell.builder.reference(cell.config, cell.traffic, dtype or torch.float32, device)


def check_sample(cell, seed, frames, images, ref):
    """The reference's and the renderer's RGB of the check's sample."""
    t, c = cell.traffic, cell.traffic["check"]
    fi, xs, ys = traffic_mod.choose(seed, len(frames), c["frames"], t["xres"], t["yres"],
                                    c["pixels"])
    sel = [frames[i] for i in fi]
    prog = [images[i][ys[k], xs[k]] for k, i in enumerate(fi)]
    rows = [(k, x, y) for k in range(len(fi)) for x, y in zip(xs[k], ys[k])]
    ref_rgb = ref(sel, [r[0] for r in rows], [r[1] for r in rows], [r[2] for r in rows])
    return np.concatenate(prog), ref_rgb


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = None,
             overrides: dict = None, bench: dict = None, root: str = ROOT):
    """-> the result dict of one run (see module docstring). `device` None
    takes the card and fails without one; tests pass "cpu" and
    `overrides` ({"config": {...}, "traffic": {...}}) to shrink a cell,
    and `bench` and `root` to run a cell of another checkout."""
    cell = load_cell(name, bench, root=root)
    import torch

    for key in ("config", "traffic"):
        getattr(cell, key).update((overrides or {}).get(key, {}))
    if int(cell.entry["chips"]) != 1:
        raise CellError(f"cell {name}: this harness runs cells on one card")
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard(f"cell {name} needs a CUDA device; none found")
        device = "cuda"
    on_card = device.startswith("cuda")
    port = setup(cell, device)
    spans = {"compile_s": port.compile_s}
    tr = cell.traffic
    frames = traffic_mod.frames(tr, seed)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    breakdown = None
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": 1}
    if not trace:
        window, images = timed_window(port, frames, seconds)
        done = window.frames
        result["metrics"] = end_to_end(cell, window)
        result["frame_s"] = window.frame_s
    else:
        from perfbench.bench import trace as trace_mod

        done = [next(frames) for _ in range(int(tr["trace_frames"]))]
        # untraced first, before any profiler has hooked the process
        port.sync()
        t0 = time.perf_counter()
        images = [port.render(f) for f in done]
        port.sync()
        untraced_s = time.perf_counter() - t0
        report = trace_mod.profile_device(port.render, done, port.samples_per_frame, port.sync)
        host = trace_mod.profile_host(port.render, done, port.sync)
        report.idle_by_host = host.idle_by_host
        run = Run(port, spans, report, done)
        run.untraced_s = untraced_s
        result["metrics"] = per_layer(cell, run)
        device_info.update(busy_s=report.busy_s, window_s=report.window_s)
        breakdown = {"device_ops": report.top_device_ops(), "idle_gaps": report.top_idle()}
        result["traced_s"] = {"device_only": report.window_s, "host_and_device": host.window_s,
                              "untraced": run.untraced_s}
    result["attempted"] = len(done)
    device_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated())
                                        if on_card else 0)
    result["device"] = device_info
    if breakdown is not None:
        result["breakdown"] = breakdown
    port.close()
    result["correct"], result["check"] = judge(cell, seed, done, images, device)
    return result


def read_all(readers, source) -> dict:
    """The metrics whose readers found something in `source`."""
    out = {}
    for m, reader in readers:
        v = reader.read(source)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def end_to_end(cell, window: Window) -> dict:
    """The cell's end-to-end metrics of a window."""
    return read_all(cell.end_to_end, window)


def per_layer(cell, run: Run) -> dict:
    """The cell's per-layer metrics that their readers found something for."""
    return read_all(cell.per_layer, run)


def judge(cell, seed, frames, images, device):
    """-> (correct, {number: {value, limit}}) of the window's frames
    against the configuration's plain reference, by its own comparison
    where its module gives one."""
    ref = reference_for(cell, device)
    prog, ref_rgb = check_sample(cell, seed, frames, images, ref)
    compare = getattr(cell.builder, "compare", check.compare)
    correct, rows = check.judge(compare(prog, ref_rgb), cell.traffic["check"]["limits"])
    return bool(correct), {k: {"value": v, "limit": lim} for k, v, lim in rows}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    except CellError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 3
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that the run may not load: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    lat = result.pop("frame_s", None)
    if lat:
        print(f"frame_s {json.dumps(lat)}", file=sys.stderr)
    traced = result.pop("traced_s", None)
    if traced:
        print(f"traced_s {json.dumps(traced)}", file=sys.stderr)
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0

