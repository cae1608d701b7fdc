"""The readers of the program's own spans (bench/spans.py and the six
metrics that read it): on the CPU, a cell shrunk to a size that still
goes through the wide packet traversal gives `k2_waves_per_traversal`
and `wide_bvh_share` a number, replay A counts every span the sync
readers read (they read on a card only: a CPU run waits on nothing), and
every reader leaves the program's tracing off; the idle split on
synthetic rows; a program without spans gives None. On the card (gpu
marker): a preview frame's sync spans are the syncs torch's sync debug
mode reports, and every K2 launch's kernels run inside its wave on the
spans' clock."""
import copy
import traceback
import types
import warnings

import pytest

from perfbench.bench import harness, spans, traffic
from perfbench.bench.loader import ROOT, import_file, load_cell

NEW = ("phase_a_idle_share", "path_loop_idle_share", "sync_wait_share",
       "host_syncs_per_frame", "k2_waves_per_traversal", "wide_bvh_share")
CPU = ("k2_waves_per_traversal", "wide_bvh_share")     # the readers that read on the CPU


def reader(name):
    return import_file(f"{ROOT}/perfbench/metrics/{name}.py", f"spans_{name}")


def wide_cell(cell):
    """tiny() with a sphere of 8,192 triangles: at the size that picks
    the wide packet traversal."""
    from conftest import tiny

    ov = copy.deepcopy(tiny(cell))
    ov["config"]["sphere"].update(n_theta=64, n_phi=64)
    return ov


@pytest.fixture(scope="module")
def shrunk_run():
    """A traced run of the shrunk preview cell on the CPU, with the Run
    its readers read."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cell = load_cell("sphere135k.preview256")
    ov = wide_cell("sphere135k.preview256")
    for key in ("config", "traffic"):
        getattr(cell, key).update(ov[key])
    port = harness.setup(cell, "cpu")
    frames = traffic.frames(cell.traffic, 2**31 + 7)
    run = harness.Run(port, {"compile_s": port.compile_s}, None,
                      [next(frames) for _ in range(2)])
    yield run
    port.close()
    torch.set_num_threads(n)


def test_host_readers_read_a_shrunk_cell(shrunk_run):
    from pbrt_tpu_torch.core import probes

    got = {}
    for name in NEW:
        got[name] = reader(name).read(shrunk_run)
        assert not probes.enabled(), name
    assert {k for k, v in got.items() if v is not None} == set(CPU)
    assert got["k2_waves_per_traversal"] >= 1
    assert 0 < got["wide_bvh_share"] < 100
    h = spans.host(shrunk_run)
    assert h.frames == 2 and h.count("sync/k2_done") == h.count("accel/k2")
    assert h.count("sync/") > h.count("sync/k2_done") > 0
    assert 0 < h.seconds("sync/") < h.seconds(spans.FRAME)
    # what the sync readers read on a card
    device, shrunk_run.port.device = shrunk_run.port.device, types.SimpleNamespace(type="cuda")
    try:
        assert reader("host_syncs_per_frame").read(shrunk_run) == h.count("sync/") / 2
        assert reader("sync_wait_share").read(shrunk_run) == pytest.approx(
            100 * h.seconds("sync/") / h.seconds(spans.FRAME))
    finally:
        shrunk_run.port.device = device


def test_a_run_leaves_tracing_off_and_reports_them():
    from pbrt_tpu_torch.core import probes

    r = harness.run_cell("sphere135k.preview256", 2**31 + 9, 0.1, True, device="cpu",
                         overrides=wide_cell("sphere135k.preview256"))
    assert not probes.enabled() and probes.spans() == []
    assert set(CPU) <= set(r["metrics"]) and r["correct"]


def test_a_failing_replay_leaves_tracing_off():
    from pbrt_tpu_torch.core import probes

    def boom():
        with probes.scope("render/frame"):
            raise RuntimeError("replay failed")

    run = types.SimpleNamespace(replay=boom)
    with pytest.raises(RuntimeError):
        reader("k2_waves_per_traversal").read(run)
    assert not probes.enabled()


def test_a_program_without_spans_gives_none(monkeypatch):
    from pbrt_tpu_torch.core import probes

    monkeypatch.delattr(probes, "enable")
    run = types.SimpleNamespace(replay=lambda: 1.0, port=None)
    for name in NEW:
        assert reader(name).read(run) is None, name


def _span(name, s, e, parent=-1):
    return types.SimpleNamespace(name=name, start_ns=s, end_ns=e, parent=parent)


class _Ev:
    """A profiler event of a device-only trace."""

    def __init__(self, name, s, d):
        self._n, self._s, self._d = name, s, d

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA


def test_idle_split_by_innermost_span():
    # frame [0, 1000): a tile [0, 790) holding a bounce [100, 700) that
    # holds Phase A [200, 300) and K2 [300, 350); the device busy
    # [150, 250) and [320, 600), and K2's annotation mirrored on the
    # device [300, 350), which is not a row
    rows = [_span("render/frame", 0, 1000), _span("render/tile", 0, 790, 0),
            _span("path/bounce", 100, 700, 1), _span("accel/phase_a", 200, 300, 2),
            _span("accel/k2", 300, 350, 2)]
    events = [_Ev("add_kernel", 150, 100), _Ev("k2_sweep_kernel", 320, 280),
              _Ev("accel/k2", 300, 50), _Ev("late_kernel", 1200, 10)]
    r = spans.reduce_idle(events, rows)
    # gaps [0, 150) mid 75: the tile; [250, 320) mid 285: Phase A;
    # [600, 1000) mid 800: the frame (the tile ended at 790)
    assert r.by_span == {"render/tile": pytest.approx(150e-9),
                         "accel/phase_a": pytest.approx(70e-9),
                         "render/frame": pytest.approx(400e-9)}
    assert r.idle_s == pytest.approx(620e-9)
    assert r.share("accel/phase_a") == pytest.approx(100 * 70 / 620)
    assert sum(r.share(k) for k in r.by_span) == pytest.approx(100.0)
    assert [n for _, _, n in r.device] == ["add_kernel", "k2_sweep_kernel"]
    assert spans.name_gaps([(2000, 2100)], rows) == {spans.OUTSIDE: pytest.approx(1e-7)}
    assert spans.reduce_idle(events, rows[1:]) is None       # no frame: no window


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture(scope="module")
def preview_port():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = load_cell("sphere135k.preview256")
    port = harness.setup(cell, "cuda")
    frame = next(traffic.frames(cell.traffic, 2**31 + 11))
    port.render(frame)
    yield port, frame
    port.close()


@pytest.mark.gpu
def test_sync_spans_are_the_sync_debug_modes_syncs(card, preview_port):
    import torch

    port, frame = preview_port
    run = harness.Run(port, {}, None, [frame])
    n_spans = reader("host_syncs_per_frame").read(run)
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message) and any(
                "pbrt_tpu_torch" in f.filename for f in traceback.extract_stack()):
            seen.append(f"{filename}:{lineno}")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        port.sync()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            port.render(frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert len(seen) > 100
    assert n_spans == len(seen)


@pytest.mark.gpu
def test_k2_kernels_run_inside_their_waves_on_the_spans_clock(card, preview_port):
    port, frame = preview_port
    run = harness.Run(port, {}, None, [frame])
    r = spans.idle(run)
    k2 = sorted(s.start_ns for s in r.spans if s.name == "accel/k2")
    done = sorted(s.end_ns for s in r.spans if s.name == "sync/k2_done")
    items = sorted((a, b) for a, b, n in r.device if "k2_items_kernel" in n)
    sweeps = sorted((a, b) for a, b, n in r.device if "k2_sweep_kernel" in n)
    assert len(items) == len(sweeps) == len(k2) == len(done) > 10
    for s0, d1, (a, _), (_, b) in zip(k2, done, items, sweeps):
        assert s0 <= a and b <= d1     # launched in its span, done before its done test ends
    assert 99.0 <= sum(r.share(k) for k in r.by_span) <= 101.0
