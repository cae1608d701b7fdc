"""A configuration, its cells and an end-to-end metric added as files
alone: a checkout with a new scene whose camera is its own (fixed, or a
list of poses), with a comparison of its own and a new end-to-end
reader, and nothing of the harness edited, runs and is checked against
the new configuration's reference."""
import copy
import json
import os
import shutil

import pytest

from perfbench.bench import harness
from perfbench.bench.loader import ROOT

CONFIG = "offaxis"
EYE = [1.5, 1.0, -4.0]        # eye.x differs from look.x: no orbit view of the harness
COMPARE = """

def compare(prog, ref):
    from perfbench.bench import check

    return dict(check.compare(prog, ref), max_abs_diff=float(abs(prog - ref).max()))
"""


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "sphere135k.json").read_text())
    cfg.update(name=CONFIG, sphere=dict(cfg["sphere"], n_theta=16, n_phi=16),
               camera=dict(cfg["camera"], eye=EYE))
    (pb / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    (pb / "configs" / f"{CONFIG}.py").write_text(
        (pb / "configs" / "sphere135k.py").read_text() + COMPARE)
    base = {"config": CONFIG, "xres": 16, "yres": 12, "spp": 2, "tile_samples": 128,
            "trace_frames": 1,
            "check": {"frames": 2, "pixels": 192,
                      "limits": {"bad_pixel_pct": 2.0, "mean_rel_diff": 0.02,
                                 "max_abs_diff": 0.01}}}
    cells = {f"{CONFIG}.fixed": dict(base, camera={"motion": "fixed"}),
             f"{CONFIG}.poses": dict(base, camera={"motion": "poses", "poses": [
                 [EYE, [0.0, 0.4, 0.0], [0.0, 1.0, 0.0]],
                 [[-2.0, 2.0, -3.0], [0.2, 0.3, 0.0], [0.0, 1.0, 0.0]]]})}
    for name, t in cells.items():
        (pb / "workloads" / f"{name}.json").write_text(json.dumps(t))
    (pb / "end_to_end" / "frames_done.py").write_text(
        "def read(window):\n    return len(window.frames)\n")
    bench = copy.deepcopy(bench)
    bench["configs"].append({"name": CONFIG, "source": "a test", "reduced": [],
                             "file": f"perfbench/configs/{CONFIG}.json", "why": "a test"})
    bench["workloads"] += [{"name": n, "config": CONFIG, "traffic": n.split(".")[1],
                            "chips": 1, "why": "a test"} for n in cells]
    bench["end_to_end"].append({"name": "frames_done", "unit": "frames", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": list(cells)})
    for m in bench["per_layer"]:
        m["workloads"] = m.get("workloads", []) + list(cells)
    return str(root), bench


@pytest.mark.parametrize("cell", [f"{CONFIG}.fixed", f"{CONFIG}.poses"])
def test_a_cell_added_as_files_runs_and_is_checked(cell, tmp_path):
    root, bench = _checkout(tmp_path)
    r = harness.run_cell(cell, 2**31 + 5, 0.3, False, device="cpu", bench=bench, root=root)
    assert r["correct"], r["check"]
    assert r["check"]["bad_pixel_pct"]["value"] == 0.0
    assert r["check"]["max_abs_diff"]["limit"] == 0.01
    assert r["metrics"]["frames_done"]["value"] == r["attempted"] >= 1
    assert {"samples_per_s", "setup_s"} <= set(r["metrics"])


def test_the_fixed_camera_is_the_scenes_own(tmp_path):
    # a frame without a pose is seen from the scene's camera: the check
    # holds it to the configuration's eye, and refuses another eye
    root, bench = _checkout(tmp_path)
    cell = harness.load_cell(f"{CONFIG}.fixed", bench, root=root)
    port = harness.setup(cell, "cpu")
    frame = next(harness.traffic_mod.frames(cell.traffic, 7))
    assert frame.eye is None
    image = port.render(frame)
    port.close()
    ok, numbers = harness.judge(cell, 7, [frame], [image], "cpu")
    assert ok, numbers
    cell.config["camera"] = dict(cell.config["camera"], eye=[1.4, 1.0, -4.0])
    ok, numbers = harness.judge(cell, 7, [frame], [image], "cpu")
    assert not ok, numbers
