"""The adaptive sampler's two-pass tile, film checkpoints and the probe
counters of the port against the JAX package's.

An adaptive (contrast) render of the slice scene through both entry
points, with the statistics counters of both packages; a render
checkpointed mid-way and resumed from the file it left, bit for bit
against the uninterrupted render; the checkpoint's compatibility check.
"""
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import scene_text  # noqa: E402

from pbrt_tpu.core import probes as j_probes  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu_torch.core import probes as t_probes  # noqa: E402
from pbrt_tpu_torch.renderers import driver  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

ADAPTIVE = 'Sampler "adaptive" "integer minsamples" [2] "integer maxsamples" [4]'


def adaptive_text(res=16, depth=2, sampler=ADAPTIVE):
    return scene_text(res=res, spp=4, depth=depth).replace(
        'Sampler "lowdiscrepancy" "integer pixelsamples" [4]', sampler)


def render(api, parser, path, **options):
    api.pbrt_init({"quiet": True, "write": False, "device": "cpu", **options})
    try:
        parser.parse_file(str(path))
        return np.asarray(api._state.output)
    finally:
        api._state.__init__()


@pytest.mark.parametrize("method", ["contrast", "shapeid"])
def test_adaptive_render_and_counters_match_jax(tmp_path, method):
    """16x16, minsamples 2, maxsamples 4, path maxdepth 2, 64-pixel tiles
    (four tiles), by either veto: agree()'s limits against the JAX
    render (image mean within 0.5%, 99% of pixels within 1e-3
    relative), the veto fires on some pixels but not all, and the
    statistics counters (render/tiles, render/camera_samples) equal the
    JAX package's."""
    path = tmp_path / "scene.pbrt"
    path.write_text(adaptive_text(sampler=f'{ADAPTIVE} "string method" "{method}"'))
    j_probes.reset()
    ref = render(j_api, j_parser, path, tile_samples=256)
    j_counts = j_probes.counters()
    t_probes.reset()
    got = render(t_api, t_parser, path, tile_samples=256)
    assert t_probes.counters() == j_counts == {"render/tiles": 4,
                                               "render/camera_samples": 16 * 16 * 4}
    assert 0 < driver.last_stats["adaptive_vetoed"] < 16 * 16
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


def test_checkpoint_resume_is_bit_equal(tmp_path):
    """A render that checkpoints every 5 tiles (1 pixel a tile, 64
    tiles) leaves the state after tile 60 (never after the last); a
    render resumed from that file starts at tile 60 and ends bit-equal
    to the uninterrupted one."""
    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(res=8, spp=4, depth=2))
    ckpt = str(tmp_path / "film.npz")
    opts = dict(tile_samples=4, checkpoint=ckpt, checkpoint_every=5)
    full = render(t_api, t_parser, path, **opts)
    assert driver.last_stats["start_tile"] == 0 and driver.last_stats["tiles"] == 64
    z = np.load(ckpt)
    assert int(z["tile"]) == 60 and tuple(z["shape"]) == (8, 8)
    assert int(z["spp"]) == 4 and int(z["seed"]) == 0
    assert set(z.files) == {"xyz", "weight", "tile", "shape", "spp", "seed"}
    resumed = render(t_api, t_parser, path, **opts)
    assert driver.last_stats["start_tile"] == 60 and driver.last_stats["tiles"] == 4
    np.testing.assert_array_equal(resumed, full)
    assert full.mean() > 0


def test_incompatible_checkpoint_is_ignored(tmp_path, capsys, monkeypatch):
    """A checkpoint of another seed (or shape or spp) warns and the
    render starts from tile 0."""
    from pbrt_tpu_torch.core import error

    monkeypatch.setattr(error, "quiet", False)
    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(res=4, spp=1, depth=1))
    ckpt = str(tmp_path / "film.npz")
    np.savez(ckpt, xyz=np.zeros((4, 4, 3), np.float32), weight=np.zeros((4, 4), np.float32),
             tile=3, shape=(4, 4), spp=1, seed=5)
    t_api.pbrt_init({"write": False, "device": "cpu", "tile_samples": 4, "checkpoint": ckpt})
    try:
        t_parser.parse_file(str(path))
    finally:
        t_api._state.__init__()
    assert "checkpoint incompatible with this render; ignoring" in capsys.readouterr().err
    assert driver.last_stats["start_tile"] == 0


def test_verbose_prints_statistics(tmp_path, capsys):
    """--verbose prints the counters at WorldEnd."""
    from pbrt_tpu_torch import main as t_main

    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(res=4, spp=1, depth=1))
    t_probes.reset()
    assert t_main.main(["--device", "cpu", "--verbose", "--tile-samples", "8",
                        "--outfile", str(tmp_path / "o.pfm"), str(path)]) == 0
    err = capsys.readouterr().err
    assert "Statistics:" in err and "render/tiles" in err and "render/camera_samples" in err
    assert t_probes.counters() == {"render/tiles": 2, "render/camera_samples": 16}
