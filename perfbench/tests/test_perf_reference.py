"""The plain reference against the renderer on a CPU frame, and the
control (the reference in bfloat16) that the check must refuse."""
import numpy as np
import pytest
import torch

from perfbench.bench import check, harness, traffic
from perfbench.bench.loader import load_cell
from perfbench.reference import pathtrace

from conftest import tiny


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["sphere135k.final1024", "sphere135k.preview256"])
def test_reference_agrees_with_the_port_on_a_cpu_frame(cell, trace):
    r = harness.run_cell(cell, 2**31 + 77, 0.2, trace, device="cpu", overrides=tiny(cell))
    assert r["correct"], r["check"]
    assert r["check"]["bad_pixel_pct"]["value"] == 0.0
    assert r["check"]["mean_rel_diff"]["value"] < 1e-5
    assert list(r)[-1] == "check"
    if trace:
        # the CPU has no device rows: only the set-up span reads
        assert set(r["metrics"]) == {"compile_s"}
        assert r["breakdown"]["device_ops"] == []
    else:
        assert r["metrics"]["samples_per_s"]["value"] > 0


def _frames_and_images(cell_name, seed, n):
    cell = load_cell(cell_name)
    ov = tiny(cell_name)
    cell.config.update(ov["config"])
    cell.traffic.update(ov["traffic"])
    port = harness.setup(cell, "cpu")
    it = traffic.frames(cell.traffic, seed)
    frames = [next(it) for _ in range(n)]
    return cell, frames, [port.render(f) for f in frames]


def test_control_in_bfloat16_fails_the_check():
    seed = 2**31 + 78
    cell, frames, images = _frames_and_images("sphere135k.final1024", seed, 3)
    ref = harness.reference_for(cell, "cpu")
    prog, ref_rgb = harness.check_sample(cell, seed, frames, images, ref)
    assert ref_rgb.mean() > 0.01                       # a lit frame, not a black one
    ok, _ = check.judge(check.compare(prog, ref_rgb), cell.traffic["check"]["limits"])
    assert ok
    low = harness.reference_for(cell, "cpu", torch.bfloat16)
    _, ctl = harness.check_sample(cell, seed, frames, images, low)
    numbers = check.compare(ctl, ref_rgb)
    ok, rows = check.judge(numbers, cell.traffic["check"]["limits"])
    assert not ok, rows
    assert numbers["bad_pixel_pct"] > 20.0


def test_reference_spectra_are_smits():
    white = pathtrace.rgb_to_spectrum((1.0, 1.0, 1.0))
    assert white.shape == (30,) and np.all(np.abs(white - 0.998) < 0.003)
    # a saturated colour mixes white with a secondary and a primary
    red = pathtrace.rgb_to_spectrum((1.0, 0.0, 0.0))
    assert red[-1] > 0.9 and red[0] < 0.2


def test_reference_hits_the_closest_triangle():
    tris = np.array([[[0, 0, 2], [1, 0, 2], [0, 1, 2]],
                     [[0, 0, 1], [1, 0, 1], [0, 1, 1]],
                     [[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float64)   # 1 and 2 tie
    t = pathtrace.Triangles(tris, torch.float32, "cpu")
    o = torch.tensor([[0.2, 0.2, 0.0], [0.2, 0.2, 0.0], [5.0, 5.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    tt, prim = t.closest(o, d, torch.tensor([10.0, 0.5, 10.0]))
    assert prim.tolist() == [1, -1, -1]
    assert tt[0].item() == pytest.approx(1.0)
