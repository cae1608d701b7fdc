"""The metric arithmetic on synthetic rows."""
import types

import numpy as np
import pytest
import torch

from perfbench.bench import roofline, stats, trace
from perfbench.bench.loader import import_file, ROOT


def test_rate_covers_all_work_and_all_time():
    # three frames of 1,048,576 samples from t = 10 s to t = 25 s
    assert stats.rate(3 * 1048576, 10.0, 25.0) == pytest.approx(3 * 1048576 / 15.0)


def test_p90_is_over_every_frame():
    lat = list(np.linspace(0.40, 0.49, 10)) * 9 + [2.0] * 10   # 100 frames, 10 stalls
    p90 = stats.percentile(lat, 90)
    assert 0.49 <= p90 < 2.0
    assert stats.percentile(lat, 95) == pytest.approx(2.0)
    assert stats.percentile(range(101), 90) == pytest.approx(90.0)


def test_k2_bound_is_chip_smokes():
    import chip_smoke

    rng = np.random.RandomState(3)
    for _ in range(20):
        pairs, blocks, tiles, listed, n_tiles = (int(x) for x in rng.randint(1, 50000, 5))
        f_s, b_s = roofline.k2_launch_bound(pairs, blocks, tiles, listed, n_tiles)
        f_ms, b_ms = chip_smoke.k2_launch_bound(pairs, blocks, tiles, listed, n_tiles)
        assert f_s * 1e3 == pytest.approx(f_ms, rel=1e-12)
        assert b_s * 1e3 == pytest.approx(b_ms, rel=1e-12)
    assert roofline.PEAK_F32 == chip_smoke.PEAK_F32
    assert roofline.PEAK_BYTES == chip_smoke.PEAK_BYTES
    assert roofline.MT_FLOPS == chip_smoke.MT_FLOPS


def test_k2_work_is_chip_smokes():
    import chip_smoke

    sentinel = 40
    count = torch.tensor([3, 0, 2, 5], dtype=torch.int32)
    pair_block = torch.tensor([1, 2, sentinel, 7, 7, 1, 9, sentinel, 3, sentinel, 0, 0],
                              dtype=torch.int32)
    dev, n_tiles = roofline.k2_work(pair_block, None, count, sentinel)
    ref_dev, (ref_tiles,) = chip_smoke.k2_work(pair_block, None, count, None, None, sentinel,
                                                None, None)
    assert dev.tolist() == ref_dev.tolist() == [7, 5, 3, 10] and n_tiles == ref_tiles == 4


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, other):
        return 1.0


def test_k1_bound_is_chip_smokes(monkeypatch):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: None, raising=False)
    rng = np.random.RandomState(5)
    for R, n_tris in ((4096, 6), (16384, 7204), (1000, 1)):
        rays8 = torch.as_tensor(rng.rand(R, 8).astype(np.float32))
        tris9 = torch.zeros(n_tris * 9)
        out = (torch.zeros(R), torch.zeros(R, dtype=torch.int32))
        rec = chip_smoke.K1Recorder(lambda *a: out, lambda *a: out)
        rec(rays8, tris9, n_tris)
        live = int((rays8[:, 6] < rays8[:, 7]).sum())
        f_s, b_s = roofline.k1_launch_bound(R, live, n_tris)
        assert f_s * 1e3 == pytest.approx(rec.flops_ms, rel=1e-12)
        assert b_s * 1e3 == pytest.approx(rec.bytes_ms, rel=1e-12)


class _Ev:
    def __init__(self, name, s, d, dev=False, thread=1):
        from torch.autograd import DeviceType

        self._n, self._s, self._d, self._t = name, s, d, thread
        self._dev = DeviceType.CUDA if dev else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def start_thread_id(self):
        return self._t


def _events():
    w = trace.WINDOW
    return [_Ev(w, 0, 1000), _Ev(w, 0, 1000, dev=True),            # the window and its mirror
            _Ev("aten::nonzero", 100, 300), _Ev("cudaStreamSynchronize", 150, 200),
            _Ev("aten::add", 600, 50),
            _Ev("k2_sweep_kernel", 0, 200, dev=True), _Ev("k2_merge_kernel", 150, 100, dev=True),
            _Ev("add_kernel", 700, 100, dev=True), _Ev("outside", 2000, 10, dev=True)]


def test_trace_reduction():
    r = trace.reduce_events(_events(), samples=4000)
    assert r.window_s == pytest.approx(1000e-9)
    assert r.busy_s == pytest.approx(350e-9)          # [0, 250) and [700, 800)
    assert r.device_ops == 3
    assert r.by_name["k2_sweep_kernel"] == [pytest.approx(200e-9), 1]
    # gaps: [250, 700) mid 475 after aten::nonzero ended; [800, 1000) mid 900
    assert r.idle_by_host["after aten::nonzero"] == pytest.approx(450e-9)
    assert r.idle_by_host["after aten::add"] == pytest.approx(200e-9)
    assert r.top_device_ops(1) == [["k2_sweep_kernel", pytest.approx(200e-9)]]


def test_per_layer_readers():
    r = trace.reduce_events(_events(), samples=4000)
    # the traced frames took 1,000 ns untraced; the device was busy 350 ns
    run = types.SimpleNamespace(trace=r, spans={"compile_s": 1.5}, untraced_s=1000e-9)

    def reader(name):
        return import_file(f"{ROOT}/perfbench/metrics/{name}.py", f"m_{name}").read(run)

    assert reader("compile_s") == 1.5
    assert reader("device_ops_per_ksample") == pytest.approx(3 / 4.0)
    assert reader("device_idle_share") == pytest.approx(65.0)
    run.untraced_s = 2000e-9
    assert reader("device_idle_share") == pytest.approx(82.5)
    run.untraced_s = None
    assert reader("device_idle_share") is None
    empty = types.SimpleNamespace(trace=trace.TraceReport(1.0, 0.0, 0, 100), spans={},
                                  untraced_s=1.0)
    run.trace, run.spans = empty.trace, {}
    for name in ("compile_s", "device_ops_per_ksample", "device_idle_share",
                 "k2_roofline_share"):
        assert reader(name) is None     # nothing to read: no number, never 0


def test_device_only_reduction():
    # a device-only trace: the device's rows and the runtime's host rows,
    # no window span; the window is the host clock's
    evs = [_Ev("cudaLaunchKernel", 90, 5), _Ev("k2_sweep_kernel", 100, 200, dev=True),
           _Ev("k2_merge_kernel", 250, 100, dev=True), _Ev("add_kernel", 700, 100, dev=True)]
    r = trace.reduce_device(evs, window_s=2e-6, samples=1000)
    assert r.window_s == 2e-6
    assert r.busy_s == pytest.approx(350e-9)          # [100, 350) and [700, 800)
    assert r.device_ops == 3 and r.idle_by_host == {}
    assert r.by_name["k2_merge_kernel"] == [pytest.approx(100e-9), 1]
    none = trace.reduce_device([_Ev("cudaLaunchKernel", 90, 5)], window_s=1.0, samples=10)
    assert none.busy_s == 0 and none.device_ops == 0


def test_end_to_end_readers():
    from perfbench.bench.harness import Window

    lat = [5.0, 5.0, 5.0]
    w = Window(frames=[0, 1, 2], samples=3 * 1048576, frame_s=lat, t_first=10.0, t_end=25.0,
               setup_s=9.5)

    def reader(name):
        return import_file(f"{ROOT}/perfbench/end_to_end/{name}.py", f"e_{name}").read(w)

    assert reader("samples_per_s") == pytest.approx(3 * 1048576 / 15.0)
    assert reader("preview_frame_p90_s") == pytest.approx(5.0)
    assert reader("setup_s") == 9.5
