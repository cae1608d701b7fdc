"""The benchmark's `disp` configuration against the port on the CPU.

perfbench/configs/disp.py builds tests/goldens/disp.pbrt through the
port's scene API, and perfbench/reference/disp.py (the eye pass) and
disp_shoot.py (the shoot) are the plain references that the benchmark's
check holds the port's frames to. Here:

- the scene the configuration emits compiles to the same tensors as the
  parsed golden;
- the plain shooter stores the port's photons at 100 caustic and no
  indirect photons wanted (6-7 batches of 4,096 paths): the same counts
  of caustic, indirect and direct photons, the caustic map's power
  within 1e-6 and its mean position within 1e-5;
- the eye pass agrees with the port on a 16 x 12 crop over the caustic
  at 1 sample a pixel, for two frame seeds whose shoots end at 6 batches
  with 100 caustic and 1 indirect photon wanted (so both maps are
  read): at most 1% of the pixels off by 1e-3 of the reference's value,
  and the means within 1e-4, the limits of the rainbowc test (a path
  that meets a tie may branch apart in the two programs; a lower
  precision moves nearly every pixel);
- the reference's kNN equals an exact k-nearest search where no grid
  cell holds more photons than the cap, and where one does, keeps the
  port's rule: the same found sets, distances, radii and weighted
  powers as the port's `knn_lookup`;
- the references import nothing of JAX, the JAX package or the port;
- the port's `accel/quad` and `photon/lookup` spans appear on a CPU
  render of the cut disp scene at the counts PERF.md section 3 states,
  and leave its image bit for bit as it was; a cut rainbowc render
  opens neither.
"""
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.bench import traffic as traffic_mod
from perfbench.bench.loader import import_file
from perfbench.bench.port import PortRenderer
from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.scene import api, parser
from pbrt_tpu_torch.scene.compile import compile_scene
from pbrt_tpu_torch.scene.paramset import ParamSet

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = (24, 40, 44, 56)    # x0, x1, y0, y1: across the caustic under the sphere
SEEDS = (17, 21)           # shoots that end at 6 batches with 100 caustic and 1 indirect photon


@pytest.fixture(autouse=True)
def _unwrapped_shooter():
    """The configuration wraps the port's build_photon_maps in the
    benchmark's recorder: other tests get the function back."""
    from pbrt_tpu_torch.photon import shooter

    build = shooter.build_photon_maps
    yield
    shooter.build_photon_maps = build


def _config(name="disp", cell="disp.golden64"):
    with open(os.path.join(ROOT, "perfbench", "configs", f"{name}.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "perfbench", "workloads", f"{cell}.json")) as f:
        work = json.load(f)
    return cfg, work, import_file(os.path.join(ROOT, "perfbench", "configs", f"{name}.py"),
                                  f"perfbench_config_{name}_test")


def _quotas(cfg, caustic, indirect):
    cfg = copy.deepcopy(cfg)
    cfg["surface_integrator"].update(causticphotons=caustic, indirectphotons=indirect)
    return cfg


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


def _tensors(obj, prefix):
    out = {}
    for name in getattr(obj, "_fields", ()) or vars(obj):
        v = getattr(obj, name)
        if isinstance(v, torch.Tensor):
            out[f"{prefix}.{name}"] = v
    return out


def test_emitted_scene_compiles_like_the_golden():
    cfg, work, builder = _config()
    api.pbrt_init({"quiet": True})
    try:
        builder.emit_scene(api, ParamSet, cfg, work)
        ro_e = api.get_state().render_options
        api.pbrt_world_end(render=False)
    finally:
        api._state.__init__()
    api.pbrt_init({"quiet": True})
    cap = _Capture()
    try:
        parser.parse_file(os.path.join(ROOT, "tests", "goldens", "disp.pbrt"), api=cap)
    finally:
        api._state.__init__()
    ro_p = cap.ro
    assert (ro_e.surf_integrator_name, ro_e.vol_integrator_name, ro_e.sampler_name,
            ro_e.filter_name) == (ro_p.surf_integrator_name, ro_p.vol_integrator_name,
                                  ro_p.sampler_name, ro_p.filter_name) == (
        "photonmap", "emission", "lowdiscrepancy", "box")
    for pe, pp in ((ro_e.surf_integrator_params, ro_p.surf_integrator_params),
                   (ro_e.vol_integrator_params, ro_p.vol_integrator_params),
                   (ro_e.sampler_params, ro_p.sampler_params),
                   (ro_e.film_params, ro_p.film_params),
                   (ro_e.camera_params, ro_p.camera_params)):
        assert sorted(pe.items) == sorted(pp.items)
        for k in pe.items:
            assert pe.items[k][0] == pp.items[k][0]
            np.testing.assert_array_equal(np.asarray(pe.items[k][1]), np.asarray(pp.items[k][1]))
    np.testing.assert_array_equal(ro_e.camera_to_world.m, ro_p.camera_to_world.m)
    se, sp = compile_scene(ro_e, "cpu"), compile_scene(ro_p, "cpu")
    assert (se.geom.n_tris, se.geom.n_quads) == (sp.geom.n_tris, sp.geom.n_quads) == (0, 2)
    te, tp = {}, {}
    for part in ("geom", "lights", "light_dist", "volume"):
        te.update(_tensors(getattr(se, part), part))
        tp.update(_tensors(getattr(sp, part), part))
    te["material_dispersive"], tp["material_dispersive"] = (se.material_dispersive,
                                                            sp.material_dispersive)
    assert te.keys() == tp.keys() and len(te) > 20
    for k in te:
        torch.testing.assert_close(te[k], tp[k], rtol=0, atol=0, msg=k)
    # the materials: the same BSDF parameters at the same hits
    from pbrt_tpu_torch.core.geometry import Ray
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    g = torch.Generator().manual_seed(0)
    eye = torch.tensor([0.0, 1.2, -4.0])
    # 32 rays at points inside the sphere, 32 at points of the disk
    inner = torch.tensor([0.0, 1.0, 0.0]) + 0.5 * torch.nn.functional.normalize(
        torch.randn((32, 3), generator=g), dim=-1)
    xz = torch.rand((32, 2), generator=g) * 6.0 - 3.0
    floor = torch.stack([xz[:, 0], torch.full((32,), -1.0), xz[:, 1]], -1)
    d = torch.nn.functional.normalize(torch.cat([inner, floor]) - eye, dim=-1)
    n = d.shape[0]
    o = eye.expand(n, 3)
    z = torch.zeros(n)
    ray = Ray(o, d, z, torch.full((n,), 1e30), z)
    he, hp = se.intersect(ray), sp.intersect(ray)
    assert bool(he.valid.all()) and set(he.prim.tolist()) == {0, 1}
    be, bp = eval_bsdf_params(se, he), eval_bsdf_params(sp, hp)
    for k in ("kind", "kd", "kr", "kt", "eta", "vn"):
        torch.testing.assert_close(getattr(be, k), getattr(bp, k), rtol=0, atol=0, msg=k)


def test_reference_shooter_agrees_with_the_port():
    from pbrt_tpu_torch.photon import shooter
    from perfbench.reference.disp_shoot import Shooter

    cfg, work, builder = _config()
    cfg = _quotas(cfg, 100, 0)
    port = PortRenderer(builder, cfg, dict(work, xres=8, yres=8), "cpu")
    ro = port.ro
    ref = Shooter(builder.reference_scene(cfg), chunk=4)
    for seed in (5, 2**40 + 17):
        ctx = shooter.build_photon_maps(port.scene, ro.surf_integrator_params,
                                        ro.vol_integrator_params, {"seed": seed})
        want = ref.shoot(seed)
        counts = ctx.stats["counts"]
        assert (ctx.stats["shots"], counts["caustic"][0], counts["indirect"][0],
                counts["direct"][0]) == (want.shots, want.caustic, want.indirect, want.direct)
        assert 2 <= want.batches <= 8 and want.caustic >= 100 and want.direct > 1000
        assert ctx.indirect is None and want.indirect_map is None
        power = float(ctx.caustic.alpha.double().sum())
        assert abs(power - want.caustic_power) <= 1e-6 * want.caustic_power
        np.testing.assert_allclose(ctx.caustic.pos.double().mean(0).numpy(),
                                   want.caustic_mean_pos, rtol=0, atol=1e-5)
    port.close()


def test_reference_agrees_with_the_port_on_a_crop():
    cfg, work, builder = _config()
    cfg = _quotas(cfg, 100, 1)
    x0, x1, y0, y1 = CROP
    n_pix = (x1 - x0) * (y1 - y0)
    work = dict(work, spp=1, tile_samples=n_pix)
    port = PortRenderer(builder, cfg, work, "cpu")
    # a crop window whose ceil(res x fraction) lands on the crop's pixels
    port.ro.film_params.add("float", "cropwindow", [(x0 - 0.5) / work["xres"],
                                                     (x1 - 0.5) / work["xres"],
                                                     (y0 - 0.5) / work["yres"],
                                                     (y1 - 0.5) / work["yres"]])
    frames = [traffic_mod.Frame(i, s, None, None, None) for i, s in enumerate(SEEDS)]
    probes.reset()
    images = [port.render(f) for f in frames]
    queries = probes.counters().get("photon/lookup_queries", 0)
    port.close()
    assert images[0].shape == (y1 - y0, x1 - x0, 3)
    assert queries > 0
    ref = builder.reference(cfg, work, torch.float32, "cpu")
    ys, xs = np.mgrid[y0:y1, x0:x1]
    fi = np.repeat(np.arange(len(frames)), n_pix)
    got = np.concatenate([im.reshape(-1, 3) for im in images]).astype(np.float64)
    want = ref(frames, fi, np.tile(xs.ravel(), len(frames)), np.tile(ys.ravel(), len(frames)))
    # both maps were read, and the shoots agree
    assert all(v == 0.0 for v in want.photons.values()), want.photons
    assert np.all(np.isfinite(got)) and want.mean() > 0
    rel = (np.abs(got - want) / np.maximum(np.abs(want), 1e-6)).max(-1)
    assert (rel > 1e-3).mean() <= 0.01
    assert abs(got.mean() - want.mean()) <= 1e-4 * want.mean()
    # the caustic lights the crop: without its map the crop is darker
    from perfbench.reference.disp import Reference

    r = Reference(builder.reference_scene(cfg), work["xres"], work["yres"], 1)
    dark = r.render([(SEEDS[0], (None, None))], np.zeros(n_pix, np.int64), xs.ravel(),
                    ys.ravel())
    assert dark.mean() < 0.8 * want[:n_pix].mean()


def _photons(n, seed, lo, hi):
    g = torch.Generator().manual_seed(seed)
    pos = lo + (hi - lo) * torch.rand((n, 3), generator=g)
    alpha = torch.rand((n, 30), generator=g)
    wi = torch.nn.functional.normalize(torch.randn((n, 3), generator=g), dim=-1)
    return pos, alpha, wi


@pytest.mark.parametrize("case", ["under_cap", "over_cap"])
def test_reference_knn_follows_the_grid_rule(case):
    from pbrt_tpu_torch.photon import map as pmap
    from perfbench.reference.disp import CappedGrid

    k, cell, max_dist2 = 8, 0.3, 0.09
    if case == "under_cap":
        pos, alpha, wi = _photons(300, 1, 0.0, 1.5)
    else:   # 400 photons in one cell of 0.3: the cap of 24 keeps its first 24
        pos, alpha, wi = _photons(400, 2, 0.6, 0.72)
        pos = torch.cat([pos, _photons(100, 3, 0.0, 1.5)[0]])
        alpha, wi = (torch.cat([a, b]) for a, b in zip((alpha, wi), _photons(100, 3, 0.0, 1.5)[1:]))
    grid = CappedGrid(pos, alpha, wi, cell, k, max_dist2, torch.float32, "cpu")
    q = _photons(200, 4, 0.0, 1.5)[0]
    ids, valid, d2, r2 = grid.nearest(q)
    full = ((q[:, None] - pos[None]) ** 2).sum(-1)
    if case == "under_cap":
        assert int(grid.weight.max()) == 1 and int(grid.rank.max()) < grid.cap
        within = torch.where(full <= max_dist2, full, torch.full_like(full, float("inf")))
        want_d2, want_ids = torch.topk(within, k, dim=1, largest=False)
        want_valid = torch.isfinite(want_d2)
        assert torch.equal(valid, want_valid) and bool(valid.any()) and not bool(valid.all())
        assert torch.equal(torch.where(valid, ids, -1), torch.where(want_valid, want_ids, -1))
        np.testing.assert_allclose(torch.where(valid, d2, 0).numpy(),
                                   torch.where(want_valid, want_d2, 0).numpy(), rtol=1e-6,
                                   atol=1e-9)
    else:
        assert float(grid.weight.max()) > 10 and bool((grid.rank >= grid.cap).any())
        # only a cell's first `cap` photons are candidates
        assert not bool((valid & (grid.rank[ids] >= grid.cap)).any())
    # the port's lookup over the same map: the same found sets and radii
    pm = pmap.build_photon_map(pos, alpha, wi, cell, target_k=k, device="cpu")
    res = pmap.knn_lookup(pm, q, k, max_dist2)
    assert torch.equal(res.valid, valid)
    torch.testing.assert_close(torch.where(res.valid, res.dist2, 0), torch.where(valid, d2, 0),
                               rtol=0, atol=0)
    torch.testing.assert_close(res.r2_max, r2, rtol=0, atol=0)
    mine = (alpha[ids] * grid.weight[ids][..., None] * valid[..., None]).sum(1)
    torch.testing.assert_close(res.alpha.sum(1), mine, rtol=1e-6, atol=1e-6)


def test_references_import_nothing_of_the_packages():
    src = ("import sys, json\nsys.path.insert(0, %r)\nimport perfbench.reference.disp\n"
           "import perfbench.reference.disp_shoot\nprint(json.dumps(sorted(sys.modules)))\n"
           % ROOT)
    out = subprocess.run([sys.executable, "-c", src], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}
    assert "perfbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "pbrt_tpu", "pbrt_tpu_torch"}


def _traced_frame(port, seed):
    frame = traffic_mod.Frame(0, seed, None, None, None)
    off = port.render(frame)
    probes.reset()
    probes.enable(True)
    try:
        on = port.render(frame)
    finally:
        probes.enable(False)
    table = probes.span_table(probes.spans())
    counters = probes.counters()
    probes.reset()
    return off, on, (lambda name: table.get(name, (0, 0.0, 0.0))[0]), counters


def test_disp_spans_appear_at_their_counts():
    cfg, work, builder = _config()
    cfg = _quotas(cfg, 100, 1)
    port = PortRenderer(builder, cfg, dict(work, xres=16, yres=16, spp=1, tile_samples=128),
                        "cpu")
    off, on, n, counters = _traced_frame(port, SEEDS[1])
    port.close()
    assert np.array_equal(off, on) and not probes.enabled()
    tiles, shaded = n("render/tile"), n("path/direct")
    assert tiles == 2 and shaded >= tiles and n("photon/batch") == 6
    # the shoot folds the quadrics once a depth (maxphotondepth 5); a
    # tile once for the volume's first hit, once for the depth that
    # ends its loop, and twice for each depth that shades (the hit and
    # the shadow ray)
    assert n("accel/quad") == 5 * n("photon/batch") + 2 * tiles + 2 * shaded
    # two maps (caustic and indirect), one lookup each a shading depth
    assert n("photon/lookup") == 2 * shaded
    assert counters["photon/lookup_queries"] > 0


def test_rainbowc_opens_neither_span():
    cfg, work, builder = _config("rainbowc", "rainbowc.golden96")
    cfg = copy.deepcopy(cfg)
    cfg["volume_integrator"].update(stepsize=3.0, volumephotons=50)
    port = PortRenderer(builder, cfg, dict(work, xres=8, yres=8, tile_samples=128), "cpu")
    off, on, n, counters = _traced_frame(port, 5)
    port.close()
    assert np.array_equal(off, on)
    assert n("render/frame") == 1 and n("photon/batch") >= 1 and n("volume/march") == 1
    assert n("accel/quad") == 0 and n("photon/lookup") == 0
    assert "photon/lookup_queries" not in counters
