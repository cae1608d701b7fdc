"""The benchmark's `rainbowc` configuration against the port on the CPU.

perfbench/configs/rainbowc.py builds tests/goldens/rainbowc.pbrt through
the port's scene API, and perfbench/reference/rainbow.py is the plain
reference that the benchmark's check holds the port's frames to. Here:

- the scene the configuration emits compiles to the same tensors as the
  parsed golden at the same film;
- the reference agrees with the port on an 8 x 8 crop across the
  primary bow, at 1 sample a pixel, with the march's stepsize raised to
  3 (8 steps) and 50 volume photons (the image reads no photon: the
  rainbow region masks the volume map, and the scene stores no caustic
  or indirect photon), for two frame seeds: at most 1% of the pixels off
  by 1e-3 of the reference's value, and the means within 1e-4;
- the plain reference shooter (perfbench/reference/rainbow_shoot.py)
  stores the port's photons at 100 volume photons wanted (two batches of
  4,096 paths): the same counts of volume, direct and indirect photons,
  the volume map's power within 1e-6 and its mean position within 1e-5.
"""
import copy
import json
import os

import numpy as np
import pytest
import torch

from perfbench.bench import traffic as traffic_mod
from perfbench.bench.loader import import_file
from perfbench.bench.port import PortRenderer
from pbrt_tpu_torch.scene import api, parser
from pbrt_tpu_torch.scene.compile import compile_scene
from pbrt_tpu_torch.scene.paramset import ParamSet

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (44, 52, 40, 48)    # x0, x1, y0, y1: the crop across the primary bow


@pytest.fixture(autouse=True)
def _unwrapped_shooter():
    """The configuration wraps the port's build_photon_maps in the
    benchmark's recorder: other tests get the function back."""
    from pbrt_tpu_torch.photon import shooter

    build = shooter.build_photon_maps
    yield
    shooter.build_photon_maps = build


def _config():
    with open(os.path.join(ROOT, "perfbench", "configs", "rainbowc.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "workloads", "rainbowc.golden96.json")) as f:
        work = json.load(f)
    return cfg, work, import_file(os.path.join(ROOT, "perfbench", "configs", "rainbowc.py"),
                                  "perfbench_config_rainbowc_test")


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


def _emitted(builder, cfg, work):
    api.pbrt_init({"quiet": True})
    try:
        builder.emit_scene(api, ParamSet, cfg, work)
        ro = api.get_state().render_options
        api.pbrt_world_end(render=False)
    finally:
        api._state.__init__()
    return ro


def _parsed():
    api.pbrt_init({"quiet": True})
    cap = _Capture()
    try:
        parser.parse_file(os.path.join(ROOT, "tests", "goldens", "rainbowc.pbrt"), api=cap)
    finally:
        api._state.__init__()
    return cap.ro


def _tensors(obj, prefix):
    out = {}
    for name in getattr(obj, "_fields", ()) or vars(obj):
        v = getattr(obj, name)
        if isinstance(v, torch.Tensor):
            out[f"{prefix}.{name}"] = v
    return out


def test_emitted_scene_compiles_like_the_golden():
    cfg, work, builder = _config()
    ro_e, ro_p = _emitted(builder, cfg, work), _parsed()
    assert (ro_e.surf_integrator_name, ro_e.vol_integrator_name, ro_e.sampler_name,
            ro_e.filter_name) == (ro_p.surf_integrator_name, ro_p.vol_integrator_name,
                                  ro_p.sampler_name, ro_p.filter_name)
    for pe, pp in ((ro_e.surf_integrator_params, ro_p.surf_integrator_params),
                   (ro_e.vol_integrator_params, ro_p.vol_integrator_params),
                   (ro_e.sampler_params, ro_p.sampler_params)):
        assert sorted(pe.items) == sorted(pp.items)
        for k in pe.items:
            assert pe.items[k][0] == pp.items[k][0]
            np.testing.assert_array_equal(np.asarray(pe.items[k][1]), np.asarray(pp.items[k][1]))
    np.testing.assert_array_equal(ro_e.camera_to_world.m, ro_p.camera_to_world.m)
    se, sp = compile_scene(ro_e, "cpu"), compile_scene(ro_p, "cpu")
    te, tp = {}, {}
    for part in ("geom", "lights", "light_dist", "volume"):
        te.update(_tensors(getattr(se, part), part))
        tp.update(_tensors(getattr(sp, part), part))
    assert te.keys() == tp.keys() and len(te) > 20
    for k in te:
        torch.testing.assert_close(te[k], tp[k], rtol=0, atol=0, msg=k)
    # the walls' texture: the same Kd at the same hits
    from pbrt_tpu_torch.core.geometry import Ray
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    n = 64
    g = torch.Generator().manual_seed(0)
    o = torch.tensor([[-1.0, 1.0, 0.0]]).expand(n, 3)
    d = torch.nn.functional.normalize(torch.rand((n, 3), generator=g) * 0.2
                                      + torch.tensor([0.0, 0.0, 1.0]), dim=-1)
    z = torch.zeros(n)
    ray = Ray(o, d, z, torch.full((n,), 1e30), z)
    he, hp = se.intersect(ray), sp.intersect(ray)
    assert bool(he.valid.all())
    torch.testing.assert_close(eval_bsdf_params(se, he).kd, eval_bsdf_params(sp, hp).kd,
                               rtol=0, atol=0)


def test_reference_agrees_with_the_port_on_a_crop():
    cfg, work, builder = _config()
    cfg = copy.deepcopy(cfg)
    cfg["volume_integrator"].update(stepsize=3.0, volumephotons=50)
    x0, x1, y0, y1 = CROP
    n_pix = (x1 - x0) * (y1 - y0)
    work = dict(work, spp=1, tile_samples=n_pix)
    port = PortRenderer(builder, cfg, work, "cpu")
    # a crop window whose ceil(res x fraction) lands on the crop's pixels
    port.ro.film_params.add("float", "cropwindow", [(x0 - 0.5) / work["xres"],
                                                     (x1 - 0.5) / work["xres"],
                                                     (y0 - 0.5) / work["yres"],
                                                     (y1 - 0.5) / work["yres"]])
    frames = [traffic_mod.Frame(i, s, None, None, None)
              for i, s in enumerate((1234567, 2087654321))]
    images = [port.render(f) for f in frames]
    port.close()
    assert images[0].shape == (y1 - y0, x1 - x0, 3)
    from perfbench.reference.rainbow import Reference

    ref = Reference(builder.reference_scene(cfg), work["xres"], work["yres"], 1, n_pix,
                    window=CROP)
    assert ref.n_steps == 8
    ys, xs = np.mgrid[y0:y1, x0:x1]
    fi = np.repeat(np.arange(len(frames)), n_pix)
    got = np.concatenate([im.reshape(-1, 3) for im in images]).astype(np.float64)
    want = ref.render([f.seed for f in frames], fi, np.tile(xs.ravel(), len(frames)),
                      np.tile(ys.ravel(), len(frames)))
    assert np.all(np.isfinite(got)) and want.mean() > 0
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-6)).max(-1)
    assert (rel > 1e-3).mean() <= 0.01
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()


def test_reference_shooter_agrees_with_the_port():
    from pbrt_tpu_torch.photon import shooter
    from perfbench.reference.rainbow_shoot import Shooter

    cfg, work, builder = _config()
    cfg = copy.deepcopy(cfg)
    cfg["volume_integrator"].update(volumephotons=100)
    port = PortRenderer(builder, cfg, dict(work, xres=8, yres=8), "cpu")
    ro = port.ro
    ref = Shooter(builder.reference_scene(cfg), 100, chunk=2)
    for seed in (5, 2**40 + 17):
        ctx = shooter.build_photon_maps(port.scene, ro.surf_integrator_params,
                                        ro.vol_integrator_params, {"seed": seed})
        want = ref.shoot(seed)
        counts = ctx.stats["counts"]
        assert (ctx.stats["shots"], counts["volume"][0], counts["direct"][0],
                counts["indirect"][0]) == (want.shots, want.volume, want.direct, want.indirect)
        assert want.batches >= 2 and want.volume >= 100
        power = float(ctx.volume.alpha.double().sum())
        assert abs(power - want.volume_power) <= 1e-6 * want.volume_power
        np.testing.assert_allclose(ctx.volume.pos.double().mean(0).numpy(), want.volume_mean_pos,
                                   rtol=0, atol=1e-5)
    port.close()
