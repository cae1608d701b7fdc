"""The port's spans (core/probes.py) on a small render through the wide
packet traversal: off, a render records nothing and never enters
torch.profiler.record_function; on, the spans form one well-formed tree
a frame, count the tiles, bounces, waves and their done tests, leave the
image bit for bit as it was, and bracket the profiler's events of the
same names (the profiler stamps its events with time.time_ns's clock);
the scene opens no quadric-fold or photon-lookup span.

The scene: a 128-triangle matte sphere over a two-triangle floor, one
point light, `path` at depth 2, 32 x 32 at 1 spp in 4 tiles of 256
samples, traversed through wide_t_pass (the wide tree forced: the scene
is below the size that picks it) and K2's plain twin.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.accel.bvh import make_accel
from pbrt_tpu_torch.cameras.cameras import make_camera
from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.film import film as film_mod
from pbrt_tpu_torch.renderers.driver import render_sampler
from pbrt_tpu_torch.samplers.samplers import make_sampler
from pbrt_tpu_torch.scene import api, parser
from pbrt_tpu_torch.scene.compile import compile_scene
from scripts.bench_scene import uv_sphere

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

RES, DEPTH, TILE_SAMPLES = 32, 2, 256
N_TILES = RES * RES // TILE_SAMPLES
EDGE_NS = 1_000_000


def _mesh(P, idx):
    return ('Shape "trianglemesh" "integer indices" [' + " ".join(map(str, idx.tolist()))
            + '] "point P" [' + " ".join(f"{v:.6f}" for v in np.ravel(P)) + "]\n")


def _scene_text():
    floor = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]], np.float32)
    return (f'Film "image" "integer xresolution" [{RES}] "integer yresolution" [{RES}]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            'LookAt 0 1.5 -4  0 0.5 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            f'SurfaceIntegrator "path" "integer maxdepth" [{DEPTH}]\nWorldBegin\n'
            'LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]\n'
            'Material "matte" "rgb Kd" [.6 .3 .2]\n' + _mesh(*uv_sphere(8, 8, 0.6, (0, 0.6, 0)))
            + 'Material "matte" "rgb Kd" [.5 .5 .5]\n'
            + _mesh(floor, np.array([0, 2, 1, 0, 3, 2])) + "WorldEnd\n")


class _Capture:
    """Forwards to the api; WorldEnd keeps the render options and does
    not render."""

    def __init__(self):
        self.ro = None

    def __getattr__(self, name):
        return getattr(api, name)

    def pbrt_world_end(self):
        self.ro = api.get_state().render_options
        api.pbrt_world_end(render=False)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "scene.pbrt"
    path.write_text(_scene_text())
    api.pbrt_init({"quiet": True})
    cap = _Capture()
    try:
        parser.parse_file(str(path), api=cap)
    finally:
        api._state.__init__()
    compiled = compile_scene(cap.ro, "cpu")
    compiled = dataclasses.replace(compiled, accel=make_accel(compiled.geom, force="wide"))
    assert compiled.accel.wide is not None
    return cap.ro, compiled


def _render(scene):
    ro, compiled = scene
    opts = {"write": False, "device": "cpu", "tile_samples": TILE_SAMPLES, "seed": 3}
    film = film_mod.make_film(ro.film_name, ro.film_params,
                              film_mod.make_filter(ro.filter_name, ro.filter_params), opts)
    camera = make_camera(ro.camera_name, ro.camera_params, ro.camera_to_world, film.xres,
                         film.yres)
    return render_sampler(compiled, ro, film, camera,
                          make_sampler(ro.sampler_name, ro.sampler_params, opts), opts)


def _traced(fn):
    """fn() with the spans on -> (its result, the spans, the counters,
    what print_counters printed)."""
    probes.reset()
    probes.enable(True)
    try:
        out = fn()
    finally:
        probes.enable(False)
    printed = io.StringIO()
    with contextlib.redirect_stderr(printed):
        probes.print_counters()
    return out, probes.spans(), probes.counters(), printed.getvalue()


@pytest.fixture(scope="module")
def renders(scene):
    """The render untraced (counting record_function's calls), traced,
    and traced under a CPU profile."""
    calls = []
    real = torch.profiler.record_function

    def counting(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    probes.enable(False)
    probes.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", counting)
        off = _render(scene)
    off_spans = probes.spans()
    on, spans, counters, printed = _traced(lambda: _render(scene))

    def profiled():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            _render(scene)
        return prof.profiler.kineto_results.events()

    events, prof_spans, _, _ = _traced(profiled)
    probes.reset()
    return dict(off=off, off_spans=off_spans, off_calls=calls, on=on, spans=spans,
                counters=counters, printed=printed, events=events, prof_spans=prof_spans)


def _names(spans):
    out = {}
    for s in spans:
        out[s.name] = out.get(s.name, 0) + 1
    return out


def test_tracing_off_records_nothing(renders):
    assert not probes.enabled()
    assert renders["off_spans"] == []
    assert renders["off_calls"] == []
    assert probes.scope("a") is probes.scope("b")     # one shared no-op context


def test_span_tree_is_well_formed(renders):
    spans, counters = renders["spans"], renders["counters"]
    n = _names(spans)
    assert n["render/frame"] == 1
    assert n["render/tile"] == counters["render/tiles"] == N_TILES
    assert n["path/bounce"] == N_TILES * (DEPTH + 1)
    assert n["path/direct"] == N_TILES * DEPTH
    assert n["accel/traverse"] >= N_TILES * (2 * DEPTH + 1)
    for i, s in enumerate(spans):
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.name == "render/frame":
            assert s.parent == -1
            continue
        assert 0 <= s.parent < i
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    by = {"render/tile": "render/frame", "path/bounce": "render/tile",
          "accel/k2": "accel/traverse", "sync/k2_done": "accel/traverse"}
    for s in spans:
        if s.name in by:
            assert spans[s.parent].name == by[s.name]


def test_every_wave_has_one_done_test(renders):
    n = _names(renders["spans"])
    assert n["accel/k2"] > 0
    assert n["sync/k2_done"] == n["accel/k2"]
    assert n["accel/phase_a"] == n["accel/k2"] + n["accel/traverse"]


def test_tracing_leaves_the_image_bit_for_bit(renders):
    assert renders["off"].mean() > 0
    np.testing.assert_array_equal(renders["on"], renders["off"])


def test_spans_bracket_the_profilers_events(renders):
    """Each span starts before and ends after its record_function event,
    each edge within 1 ms: one clock."""
    def start_end(e):
        if hasattr(e, "start_ns"):
            return e.start_ns(), e.start_ns() + e.duration_ns()
        return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000

    spans = renders["prof_spans"]
    names = set(_names(spans))
    events = {}
    for e in renders["events"]:
        if e.name() in names:
            events.setdefault(e.name(), []).append(start_end(e))
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in spans if s.name == name)
        theirs = sorted(events.get(name, []))
        assert len(mine) == len(theirs), name
        for (s0, s1), (e0, e1) in zip(mine, theirs):
            assert 0 <= e0 - s0 <= EDGE_NS, name
            assert 0 <= s1 - e1 <= EDGE_NS, name


def test_print_counters_prints_the_span_rows(renders):
    lines = renders["printed"].splitlines()
    assert any(ln.split()[:1] == ["render/tiles"] for ln in lines)
    table = probes.span_table(renders["spans"])
    for name, (n, tot, own) in table.items():
        row = [ln.split() for ln in lines if ln.split()[:1] == [name]]
        assert len(row) == 1 and int(row[0][1].replace(",", "")) == n
        assert float(row[0][3]) <= float(row[0][2])
        assert 0.0 <= own <= tot
    assert table["render/frame"][2] < table["render/frame"][1]


def test_spans_nest_and_reset_clears_them():
    probes.reset()
    probes.enable(True)
    try:
        with probes.scope("outer"):
            with probes.scope("inner"):
                pass
            probes.spanned("deco")(lambda: None)()
    finally:
        probes.enable(False)
    rows = probes.spans()
    assert [(s.name, s.parent) for s in rows] == [("outer", -1), ("inner", 0), ("deco", 0)]
    n, tot, own = probes.span_table(rows)["outer"]
    assert n == 1 and own <= tot
    probes.reset()
    assert probes.spans() == [] and probes.counters() == {}


def test_no_quadric_fold_or_photon_lookup_span(renders):
    """The sphere scene has no quadric and no photon map: neither the
    quadric fold's span nor the surface lookup's opens."""
    names = set(_names(renders["spans"]))
    assert "render/frame" in names
    assert not names & {"accel/quad", "photon/lookup"}
    assert "photon/lookup_queries" not in renders["counters"]
