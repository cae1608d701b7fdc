"""The readings that a cell's check limits are set from.

    python3 perfbench/control.py --workload <cell> --window-frames <n> \
        --seeds <s1,s2,...> --control-seeds <c1,c2,c3> [--device cuda]

Sets the cell up once, then for each seed renders the frames that a run
of that seed whose window holds `window-frames` frames would check, and
prints one JSON line: the check's numbers for the renderer against the
plain reference (the lower readings). For each control seed it also
prints the numbers of the control: the reference itself computed in
bfloat16, the precision below the configuration's float32, in the
renderer's place (the upper readings). The benchmark's own runs do not
run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.bench import check, harness, traffic as traffic_mod  # noqa: E402
from perfbench.bench.loader import load_cell  # noqa: E402


def readings(cell, port, seed: int, n_window: int, device: str, control: bool):
    import itertools

    import torch

    stream = list(itertools.islice(traffic_mod.frames(cell.traffic, seed), n_window))
    fi, _, _ = traffic_mod.choose(seed, n_window, cell.traffic["check"]["frames"],
                                  cell.traffic["xres"], cell.traffic["yres"],
                                  cell.traffic["check"]["pixels"])
    images, times = [None] * n_window, {}
    for i in fi:
        t0 = time.perf_counter()
        images[i] = port.render(stream[i])
        times[int(i)] = time.perf_counter() - t0
    ref = harness.reference_for(cell, device)
    prog, ref_rgb = harness.check_sample(cell, seed, stream, images, ref)
    out = {"seed": seed, "frame_s": times, "program": check.compare(prog, ref_rgb)}
    if control:
        low = harness.reference_for(cell, device, torch.bfloat16)
        _, ctl = harness.check_sample(cell, seed, stream, images, low)
        out["control_bf16"] = check.compare(ctl, ref_rgb)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--window-frames", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    port = harness.setup(cell, a.device)
    seeds = [int(s) for s in a.seeds.split(",") if s]
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    for s in seeds + sorted(ctl - set(seeds)):
        print(json.dumps(readings(cell, port, s, a.window_frames, a.device, s in ctl)),
              flush=True)


if __name__ == "__main__":
    main()
