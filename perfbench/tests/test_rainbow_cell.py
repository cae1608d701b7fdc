"""The `rainbowc.golden96` cell on the CPU: the loader finds it and its four
readers; a run loads no module of JAX or of the JAX package, and of the
port's only the image reader beyond what a `sphere135k` run loads; the plain
reference (perfbench/reference/rainbow.py) agrees with a frame of the
cell shrunk by `overrides`, and its bfloat16 control fails the cell's
pixel limits; the frame's recorded photon shoot meets the plain reference
shooter (perfbench/reference/rainbow_shoot.py), and the shooter's
bfloat16 control, a shoot cut short and a frame shot by no recorded call
fail the cell's photon limits; each reader gives None where it reads
nothing, and its number on synthetic rows; the program's spans leave a
CPU image bit for bit the same and appear at the counts PERF.md states."""
import copy
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from perfbench.bench import check, harness, spans, traffic
from perfbench.bench.loader import ROOT, import_file, load_cell

CELL = "rainbowc.golden96"
READERS = ("k1_roofline_share", "march_idle_share", "photon_build_share",
           "photon_batches_per_frame")
# the cell cut to a CPU test's size: 16 x 16 pixels in two tiles (the
# second padded with copies of the last pixel), 8 march steps, one batch
# of photons (the image reads none)
SHRUNK = {"config": {"volume_integrator": {"name": "photonvolume", "stepsize": 3.0, "nused": 50,
                                           "maxdist": 0.5, "volumephotons": 50}},
          "traffic": {"xres": 16, "yres": 16, "tile_samples": 384, "trace_frames": 1,
                      "check": {"frames": 2, "pixels": 256}}}


def shrunk_cell():
    cell = load_cell(CELL)
    ov = copy.deepcopy(SHRUNK)
    ov["traffic"]["check"]["limits"] = cell.traffic["check"]["limits"]
    for key in ("config", "traffic"):
        getattr(cell, key).update(ov[key])
    return cell, ov


def reader(name):
    return import_file(f"{ROOT}/perfbench/metrics/{name}.py", f"rainbow_{name}")


@pytest.fixture(scope="module")
def port():
    cell, _ = shrunk_cell()
    p = harness.setup(cell, "cpu")
    yield cell, p
    p.close()


def test_the_loader_finds_the_cell_and_its_readers():
    cell = load_cell(CELL)
    assert cell.entry["chips"] == 1 and cell.config["name"] == "rainbowc"
    assert [m["name"] for m, _ in cell.end_to_end] == ["samples_per_s", "setup_s"]
    assert [m["name"] for m, _ in cell.per_layer] == list(READERS)
    assert all(hasattr(r, "read") for _, r in cell.per_layer)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in READERS:
            assert m["workloads"] == [CELL] and m["moves"] == "samples_per_s"
    t = cell.traffic
    assert (t["xres"], t["yres"], t["spp"], t["tile_samples"]) == (96, 96, 2, 16384)
    assert t["camera"] == {"motion": "fixed"}


_RUN = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
{body}
print(json.dumps(sorted(sys.modules)))
"""
_SPHERE = r"""
sys.path.insert(0, {tests!r})
from conftest import tiny
from perfbench.bench import harness
harness.run_cell("sphere135k.preview256", 5, 0.1, False, device="cpu",
                 overrides=tiny("sphere135k.preview256"))
"""
_RAINBOW = r"""
sys.path.insert(0, {tests!r})
from test_rainbow_cell import shrunk_cell
from perfbench.bench import harness
cell, ov = shrunk_cell()
r = harness.run_cell({cell!r}, 5, 0.1, True, device="cpu", overrides=ov)
assert r["correct"], r
"""
_REFERENCE = r"""
import perfbench.reference.rainbow
import perfbench.reference.rainbow_shoot
"""


def _modules(body):
    tests = os.path.join(ROOT, "perfbench", "tests")
    src = _RUN.format(root=ROOT, body=body.format(tests=tests, cell=CELL))
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_beyond_a_sphere135k_run():
    forbidden = {"jax", "jaxlib", "flax", "pbrt_tpu"}
    ref = {m.split(".")[0] for m in _modules(_REFERENCE)}
    assert not ref & (forbidden | {"pbrt_tpu_torch"})
    sphere, rainbow = _modules(_SPHERE), _modules(_RAINBOW)
    assert not {m.split(".")[0] for m in rainbow} & forbidden
    port = {m for m in rainbow if m.split(".")[0] == "pbrt_tpu_torch"}
    # beyond a sphere135k run's, only the image reader that the walls'
    # imagemap texture calls (it finds no image, and takes one white texel)
    assert port and port - sphere == {"pbrt_tpu_torch.io", "pbrt_tpu_torch.io.image"}


def test_the_reference_agrees_and_the_control_fails(port):
    from perfbench import control

    cell, p = port
    # control.py reads the pixels' numbers: the photon limits are the
    # next test's
    limits = {k: v for k, v in cell.traffic["check"]["limits"].items()
              if k not in cell.builder.PHOTON_NUMBERS}
    for seed in (3, 2**40 + 11):
        out = control.readings(cell, p, seed, 2, "cpu", control=True)
        ok, _ = check.judge(out["program"], limits)
        bad, _ = check.judge(out["control_bf16"], limits)
        assert ok, out["program"]
        assert not bad, out["control_bf16"]
        assert out["control_bf16"]["bad_pixel_pct"] > 10 * limits["bad_pixel_pct"]


def test_the_check_holds_the_shoot():
    from perfbench import control_photons

    cell, ov = shrunk_cell()
    cell.config["volume_integrator"] = dict(cell.config["volume_integrator"], volumephotons=150)
    b = cell.builder
    limits = cell.traffic["check"]["limits"]
    p = harness.setup(cell, "cpu")
    try:
        out = control_photons.readings(cell, p, 2**36 + 9, "cpu", cuts=(2,))
    finally:
        p.close()
    prog, ref = out["stored"]["program"], out["stored"]["reference"]
    assert prog == ref and ref[0] >= 150 and out["stored"]["batches"] == 3
    assert out["program"]["photon_count_rel_diff"] == 0.0
    assert check.judge(out["program"], {k: limits[k] for k in b.PHOTON_NUMBERS})[0]
    for bad in (out["control_bf16"], out["cut_2"],
                b.photon_numbers([None], [b.reference_shooter(cell.config, torch.float32,
                                                              "cpu").shoot(5)])):
        assert not check.judge(bad, {k: limits[k] for k in b.PHOTON_NUMBERS})[0], bad
    assert out["cut_2"]["photon_count_rel_diff"] > 0.2


def test_a_shrunk_traced_run_is_correct():
    cell, ov = shrunk_cell()
    r = harness.run_cell(CELL, 2**33 + 5, 0.1, True, device="cpu", overrides=ov)
    assert r["correct"] and r["attempted"] == 1
    # the check holds the frame's shoot as well as its pixels
    for k in cell.builder.PHOTON_NUMBERS:
        assert r["check"][k]["value"] <= r["check"][k]["limit"]
    # on the CPU: the photon readers read, the card's do not
    assert set(r["metrics"]) == {"photon_build_share", "photon_batches_per_frame"}
    assert r["metrics"]["photon_batches_per_frame"]["value"] >= 1
    assert 0 < r["metrics"]["photon_build_share"]["value"] < 100


def test_readers_give_none_where_they_read_nothing(port):
    cell, p = port
    frames = traffic.frames(cell.traffic, 7)
    run = harness.Run(p, {"compile_s": p.compile_s}, None, [next(frames)])
    assert reader("k1_roofline_share").read(run) is None        # no trace
    assert reader("march_idle_share").read(run) is None         # no card
    # a program that shoots no photon: no photon span to read
    run.spans_host = spans.HostSpans(1, {spans.FRAME: (1, 2.0, 0.5)})
    assert reader("photon_build_share").read(run) is None
    assert reader("photon_batches_per_frame").read(run) is None
    # a trace without K1's rows
    run.trace = types.SimpleNamespace(by_name={"k2_sweep_kernel": [0.5, 3]})
    assert reader("k1_roofline_share").read(run) is None


def test_readers_on_synthetic_rows():
    from pbrt_tpu_torch.core.probes import Span
    from perfbench.bench import roofline

    run = types.SimpleNamespace()
    run.spans_host = spans.HostSpans(2, {spans.FRAME: (2, 10.0, 0.1),
                                         "photon/batch": (128, 3.5, 3.5),
                                         "photon/build": (2, 1.0, 1.0)})
    assert reader("photon_build_share").read(run) == pytest.approx(45.0)
    assert reader("photon_batches_per_frame").read(run) == 64
    rows = [Span("render/frame", 0, 100, -1), Span("volume/march", 10, 60, 0)]
    run.spans_idle = spans.IdleSpans(idle_s=8.0, by_span={"volume/march": 2.0,
                                                          "volume/transmittance": 1.0,
                                                          "sync/knn_live": 3.0,
                                                          "render/tile": 2.0}, spans=rows)
    assert reader("march_idle_share").read(run) == pytest.approx(37.5)
    run.spans_idle.spans = rows[:1]      # a program without the march's span
    assert reader("march_idle_share").read(run) is None
    # K1: each tri_t_pass call of a replay counted by its live rays
    from pbrt_tpu_torch.ops import intersect_cuda

    soa = intersect_cuda.TriSoA(torch.zeros((6, 3)), torch.eye(3).repeat(2, 1),
                                torch.eye(3).roll(1, 0).repeat(2, 1))
    o, d = torch.zeros((10, 3)), torch.ones((10, 3))
    tmin = torch.zeros(10)
    tmax = torch.tensor([1.0, float("inf"), -1.0, 2.0, 3.0, -1.0, 1.0, 1.0, 1.0, 1.0])

    def replay():
        intersect_cuda.tri_t_pass(soa, o, d, tmin, tmax)
        intersect_cuda.tri_t_pass(soa, o[:4], d[:4], tmin[:4], tmax[:4])

    run = types.SimpleNamespace(trace=types.SimpleNamespace(
        by_name={"k1_sweep_kernel(float const*)": [2e-6, 2], "k1_finish_kernel": [1e-6, 2],
                 "k2_sweep_kernel": [1.0, 1]}), replay=replay)
    want = (max(roofline.k1_launch_bound(10, 8, 6)) + max(roofline.k1_launch_bound(4, 3, 6)))
    assert reader("k1_roofline_share").read(run) == pytest.approx(100.0 * want / 3e-6)
    assert intersect_cuda.tri_t_pass.__name__ == "tri_t_pass"     # the recorder is gone


def test_spans_leave_the_image_and_appear_at_their_counts(port):
    from pbrt_tpu_torch.core import probes
    from perfbench.reference.rainbow import n_steps

    cell, p = port
    frame = next(traffic.frames(cell.traffic, 2**35 + 3))
    off = p.render(frame)
    img, rows = spans.with_spans(probes, lambda: p.render(frame))
    assert np.array_equal(off, img) and not probes.enabled()
    table = probes.span_table(rows)

    def n(name):
        return table.get(name, (0, 0.0, 0.0))[0]

    tiles = n("render/tile")
    steps = n_steps(cell.builder.reference_scene(cell.config))
    assert n("render/frame") == 1 and tiles == 2
    assert n("photon/build") == 1 and n("photon/batch") >= 1
    assert n("volume/march") == tiles
    assert n("volume/march_step") == steps * tiles
    # one toward the light at each surface hit and at each march step
    assert n("volume/transmittance") == (steps + 1) * tiles
    sites = {"k2_done", "n_live", "tile_ids", "camera_xform", "vetoed", "film",
             "photon_batch", "knn_live", "walk_stop", "walk_iters"}
    assert {k.split("/", 1)[1] for k in table if k.startswith("sync/")} <= sites
    # the recorder kept the frame's shoot for the check
    shot = cell.builder.recorder().shoot(frame.seed)
    assert shot.volume >= 50 and shot.direct > 0 and shot.shots == 4096 * n("photon/batch")
