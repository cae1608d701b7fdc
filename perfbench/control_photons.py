"""The readings that a photon cell's shoot limits are set from.

    python3 perfbench/control_photons.py --workload rainbowc.golden96 \
        --seeds <s1,s2,...> [--cut <b1,b2,...>] [--device cuda]

For a configuration whose module checks the photon shoot (`recorder`,
`reference_shooter`, `photon_numbers`: perfbench/configs/rainbowc.py),
sets the cell up once, then for each seed renders the first frame of
that seed's run and prints one JSON line of the shoot's numbers: the
renderer's recorded shoot against the plain reference shooter (the lower
readings); the reference shooter computed in bfloat16, the precision
below the configuration's float32, against it in float32 (the control:
the upper readings); and the reference shooter cut to each of `--cut`
batches against the whole one (a program that shoots fewer paths). The
benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from perfbench.bench import harness, traffic as traffic_mod  # noqa: E402
from perfbench.bench.loader import load_cell  # noqa: E402


def readings(cell, port, seed: int, device: str, cuts=()) -> dict:
    import torch

    b = cell.builder
    frame = next(traffic_mod.frames(cell.traffic, seed))
    t0 = time.perf_counter()
    port.render(frame)
    frame_s = time.perf_counter() - t0
    prog = b.recorder().shoot(frame.seed)
    ref = b.reference_shooter(cell.config, torch.float32, device).shoot(frame.seed)
    low = b.reference_shooter(cell.config, torch.bfloat16, device).shoot(frame.seed)
    out = {"seed": seed, "frame_s": frame_s,
           "stored": {"program": [prog.volume, prog.direct], "reference": [ref.volume, ref.direct],
                      "batches": ref.batches},
           "program": b.photon_numbers([prog], [ref]),
           "control_bf16": b.photon_numbers([low], [ref])}
    full = b.reference_shooter(cell.config, torch.float32, device)
    for n in cuts:
        out[f"cut_{n}"] = b.photon_numbers([full.shoot(frame.seed, batches=n)], [ref])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--cut", default="")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    port = harness.setup(cell, a.device)
    cuts = [int(n) for n in a.cut.split(",") if n]
    for s in (int(s) for s in a.seeds.split(",") if s):
        print(json.dumps(readings(cell, port, s, a.device, cuts)), flush=True)


if __name__ == "__main__":
    main()
