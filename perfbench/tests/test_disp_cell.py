"""The `disp.golden64` cell on the CPU: the loader finds it and exactly its
two readers; a run loads no module of JAX or of the JAX package; the plain
references (perfbench/reference/disp.py, disp_shoot.py) agree with a
frame of the cell cut by `overrides`, and their bfloat16 controls, a
shoot cut short and a frame shot by no recorded call fail the cell's
limits; each reader gives None where it reads nothing, and its number on
synthetic rows."""
import copy
import json
import os
import subprocess
import sys
import types

import pytest
import torch

from perfbench.bench import check, harness, spans, traffic
from perfbench.bench.loader import ROOT, import_file, load_cell

CELL = "disp.golden64"
READERS = ("photon_lookup_share", "quad_fold_share")
# the cell cut to a CPU test's size: 16 x 16 pixels at 1 spp in one tile,
# 100 caustic and no indirect photons wanted (a shoot of 6-8 batches)
SHRUNK = {"config": {"surface_integrator": {"name": "photonmap", "nused": 60,
                                            "finalgather": False, "maxdist": 0.3,
                                            "indirectphotons": 0, "causticphotons": 100}},
          "traffic": {"xres": 16, "yres": 16, "spp": 1, "tile_samples": 256, "trace_frames": 1,
                      "check": {"frames": 2, "pixels": 256}}}


def shrunk_cell():
    cell = load_cell(CELL)
    ov = copy.deepcopy(SHRUNK)
    ov["traffic"]["check"]["limits"] = cell.traffic["check"]["limits"]
    for key in ("config", "traffic"):
        getattr(cell, key).update(ov[key])
    return cell, ov


def reader(name):
    return import_file(f"{ROOT}/perfbench/metrics/{name}.py", f"disp_{name}")


@pytest.fixture(scope="module")
def port():
    from pbrt_tpu_torch.photon import shooter

    build = shooter.build_photon_maps
    cell, _ = shrunk_cell()
    p = harness.setup(cell, "cpu")
    yield cell, p
    p.close()
    shooter.build_photon_maps = build     # the recorder goes with the module's tests


def test_the_loader_finds_the_cell_and_its_readers():
    cell = load_cell(CELL)
    assert cell.entry["chips"] == 1 and cell.config["name"] == "disp"
    assert cell.config["reduced"] == ["xresolution", "yresolution", "pixelsamples",
                                      "surface_integrator", "volume_integrator"]
    assert set(cell.config["reduced_from"]) == set(cell.config["reduced"])
    assert [m["name"] for m, _ in cell.end_to_end] == ["samples_per_s", "setup_s"]
    assert [m["name"] for m, _ in cell.per_layer] == list(READERS)
    assert all(hasattr(r, "read") for _, r in cell.per_layer)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "samples_per_s"
        else:
            assert CELL not in m.get("workloads", [])
    t = cell.traffic
    assert (t["xres"], t["yres"], t["spp"], t["tile_samples"]) == (64, 64, 4, 16384)
    assert t["camera"] == {"motion": "fixed"} and t["check"]["pixels"] == 64 * 64


_RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import torch
torch.set_num_threads(2)
from test_disp_cell import shrunk_cell
from perfbench.bench import harness
cell, ov = shrunk_cell()
r = harness.run_cell({cell!r}, 2**33 + 5, 0.1, True, device="cpu", overrides=ov)
assert r["correct"], r
print(json.dumps(r["metrics"]))
print(json.dumps(sorted(sys.modules)))
"""


def test_a_traced_run_is_correct_and_loads_no_jax():
    tests = os.path.join(ROOT, "perfbench", "tests")
    out = subprocess.run([sys.executable, "-c", _RUN.format(root=ROOT, tests=tests, cell=CELL)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    metrics, modules = json.loads(lines[-2]), {m.split(".")[0] for m in json.loads(lines[-1])}
    assert not modules & {"jax", "jaxlib", "flax", "pbrt_tpu"}
    assert set(metrics) == set(READERS)
    assert 0 < metrics["photon_lookup_share"]["value"] < 100
    assert 0 < metrics["quad_fold_share"]["value"] < 100


def test_the_reference_agrees_and_the_control_fails(port):
    from perfbench import control

    cell, p = port
    limits = {k: v for k, v in cell.traffic["check"]["limits"].items()
              if k not in cell.builder.PHOTON_NUMBERS}
    for seed in (3, 2**40 + 11):
        out = control.readings(cell, p, seed, 2, "cpu", control=True)
        assert check.judge(out["program"], limits)[0], out["program"]
        assert not check.judge(out["control_bf16"], limits)[0], out["control_bf16"]
        assert out["control_bf16"]["bad_pixel_pct"] > 10 * limits["bad_pixel_pct"]


def test_the_check_holds_the_shoot(port):
    from perfbench import control_photons

    cell, p = port
    b = cell.builder
    limits = {k: cell.traffic["check"]["limits"][k] for k in b.PHOTON_NUMBERS}
    out = control_photons.readings(cell, p, 2**36 + 9, "cpu", cuts=(2,))
    # control_photons.py prints the volume and direct photons stored:
    # this scene stores no volume photon
    prog, ref = out["stored"]["program"], out["stored"]["reference"]
    assert prog == ref and ref[0] == 0 and ref[1] > 1000
    assert out["program"]["photon_count_rel_diff"] == 0.0
    assert check.judge(out["program"], limits)[0]
    unrecorded = b.photon_numbers([None], [b.reference_shooter(cell.config, torch.float32,
                                                               "cpu").shoot(5)])
    for bad in (out["control_bf16"], out["cut_2"], unrecorded):
        assert not check.judge(bad, limits)[0], bad
    assert out["cut_2"]["photon_count_rel_diff"] > 0.2


def test_readers_give_none_where_they_read_nothing(port):
    cell, p = port
    frames = traffic.frames(cell.traffic, 7)
    run = harness.Run(p, {"compile_s": p.compile_s}, None, [next(frames)])
    # a program without the spans (the parent's): nothing to read
    run.spans_host = spans.HostSpans(1, {spans.FRAME: (1, 2.0, 0.5),
                                         "photon/batch": (64, 1.5, 1.4)})
    for name in READERS:
        assert reader(name).read(run) is None
    run.spans_host = None
    for name in READERS:
        assert reader(name).read(run) is None


def test_readers_on_synthetic_rows():
    run = types.SimpleNamespace()
    run.spans_host = spans.HostSpans(2, {spans.FRAME: (2, 4.0, 0.1),
                                         "photon/lookup": (12, 0.2, 0.2),
                                         "accel/quad": (656, 1.5, 1.5)})
    assert reader("photon_lookup_share").read(run) == pytest.approx(5.0)
    assert reader("quad_fold_share").read(run) == pytest.approx(37.5)
