"""The configurations and the traffic generator."""
import json
import os

import numpy as np

from perfbench.bench import traffic
from perfbench.bench.loader import ROOT, load_cell


def test_sphere135k_builds_135202_triangles():
    from pbrt_tpu_torch.scene import api
    from pbrt_tpu_torch.scene.paramset import ParamSet

    cell = load_cell("sphere135k.final1024")
    assert sum(len(idx) // 3 for _, idx, _ in cell.builder.meshes(cell.config)) == 135202
    assert cell.config["triangles"] == 135202
    if api.get_state().state != api.STATE_UNINITIALIZED:
        api.pbrt_cleanup()
    api.pbrt_init({"quiet": True})
    try:
        cell.builder.emit_scene(api, ParamSet, cell.config, cell.traffic)
        shapes = api.get_state().render_options.shapes
        n = sum(len(s.params.find_int("indices")) // 3 for s in shapes)
    finally:
        api.pbrt_world_end(render=False)
        api.pbrt_cleanup()
    assert n == 135202
    assert len(cell.builder.reference_scene(cell.config).tris) == 135202


def test_config_file_is_the_benchmark_entry():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for c in bench["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_frames_are_drawn_from_the_seed():
    t = load_cell("sphere135k.final1024").traffic
    seed = 2**31 + 12345

    def first(s, n=70):
        it = traffic.frames(t, s)
        return [next(it) for _ in range(n)]

    a, b, c = first(seed), first(seed), first(seed + 1)
    assert a == b and a != c
    # every seed renders the same set of views, in its own order
    views = {f.eye for f in a[:64]}
    assert len(views) == 64 and views == {f.eye for f in c[:64]}
    assert a[0].eye != c[0].eye or a[1].eye != c[1].eye
    assert traffic.orbit_pose(t["camera"], 0)[0] == (0.0, 1.2, -4.0)   # bench.py's LookAt


def test_check_sample_is_drawn_from_the_seed():
    fi, x, y = traffic.choose(7, 6, 4, 1024, 1024, 4096)
    fi2, x2, y2 = traffic.choose(7, 6, 4, 1024, 1024, 4096)
    assert (fi == fi2).all() and (x == x2).all() and (y == y2).all()
    assert len(set(fi.tolist())) == 4 and x.shape == (4, 4096)
    assert all(len(set((x[k] + 1024 * y[k]).tolist())) == 4096 for k in range(4))
    assert traffic.choose(7, 2, 4, 16, 16, 999)[0].tolist() == [0, 1]
    assert np.all((x >= 0) & (x < 1024) & (y >= 0) & (y < 1024))
