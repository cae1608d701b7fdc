"""The photon shoot's batch split at its traversals (photon/shooter.py
Shooter), on the CPU: the shoots that stay eager, with no `photon/graph`
span (the rule for where stretches replay, and a key whose capture
raises: tests/test_torch_graphs.py); the split draws are
integrator_uniform's; the stretches give the records of the whole batch
as it was before the split, bit for bit. The graphs themselves run on
the card: tests/test_torch_gpu.py holds them bit for bit against the
eager stretches.

Scenes: the `rainbowc` and `disp` goldens (tests/goldens); the shoots
of build_photon_maps run `rainbowc` with 100 volume photons (two
batches of 4,096 paths).
"""
import math
import os
import types

import numpy as np
import pytest
import torch

from pbrt_tpu_torch import diff
from pbrt_tpu_torch.core import graphs as cuda_graphs
from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import Ray, dot, normalize
from pbrt_tpu_torch.core.sampling import uniform_sample_sphere
from pbrt_tpu_torch.lights.lighting import sample_light_ray
from pbrt_tpu_torch.materials.bsdf import (bsdf_sample, has_non_specular, has_transmissive,
                                           material_lobes)
from pbrt_tpu_torch.photon import shooter
from pbrt_tpu_torch.samplers.samplers import integrator_uniform
from pbrt_tpu_torch.scene import api, parser
from pbrt_tpu_torch.scene.compile import compile_scene, eval_bsdf_params
from pbrt_tpu_torch.volumes.registry import intersect_p as vol_intersect_p
from pbrt_tpu_torch.volumes.registry import phase as vol_phase
from pbrt_tpu_torch.volumes.registry import sigma_at

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
SHOOT_VOLUME_PHOTONS = 100


def _compile(tmp_path_factory, name, edit=lambda s: s):
    with open(os.path.join(GOLDENS, f"{name}.pbrt")) as f:
        text = edit(f.read())
    path = tmp_path_factory.mktemp(name) / "scene.pbrt"
    path.write_text(text)
    kept = {}

    class Capture:
        def __getattr__(self, attr):
            return getattr(api, attr)

        def pbrt_world_end(self):
            kept["ro"] = api.get_state().render_options
            api.pbrt_world_end(render=False)

    api.pbrt_init({"quiet": True})
    try:
        parser.parse_file(str(path), api=Capture())
    finally:
        api._state.__init__()
    return kept["ro"], compile_scene(kept["ro"], "cpu")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return {name: _compile(tmp_path_factory, name) for name in ("rainbowc", "disp")}


@pytest.fixture(scope="module")
def small_shoot(tmp_path_factory):
    """rainbowc with a quota of SHOOT_VOLUME_PHOTONS volume photons."""
    return _compile(tmp_path_factory, "rainbowc", lambda s: s.replace(
        '"integer volumephotons"  [5000]', f'"integer volumephotons" [{SHOOT_VOLUME_PHOTONS}]'))


def _build(ro, scene, seed=5):
    return shooter.build_photon_maps(scene, ro.surf_integrator_params, ro.vol_integrator_params,
                                     {"quiet": True, "seed": seed})


def _traced(fn):
    """fn() with spans on -> (its value, span names, counters)."""
    probes.reset()
    probes.enable(True)
    try:
        out = fn()
    finally:
        probes.enable(False)
    names, counters = [s.name for s in probes.spans()], probes.counters()
    probes.reset()
    return out, names, counters


def _bit_equal(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _maps_equal(got, ref):
    """Every map's tensors bit for bit, the counts, batches and path totals."""
    for name in ("caustic", "indirect", "volume", "direct", "radiance"):
        mg, mr = getattr(got, name), getattr(ref, name)
        assert (mg is None) == (mr is None), name
        if mr is not None:
            assert mg.count == mr.count and mg.dims == mr.dims, name
            for f, v in zip(mr._fields, mr):
                if isinstance(v, torch.Tensor):
                    assert _bit_equal(getattr(mg, f), v), f"{name}.{f}"
    assert got.stats["counts"] == ref.stats["counts"]
    assert (got.stats["batches"], got.stats["shots"]) == (ref.stats["batches"], ref.stats["shots"])
    assert (got.n_caustic_paths, got.n_indirect_paths, got.n_volume_paths) == (
        ref.n_caustic_paths, ref.n_indirect_paths, ref.n_volume_paths)


def _card_lane(n=4096):
    return types.SimpleNamespace(is_cuda=True, device="cuda:0", shape=(n,))


@pytest.mark.parametrize("how", ["cpu", "autograd", "shoot_batch_fn"])
def test_the_cpu_autograd_and_shoot_batch_fn_replay_nothing(small_shoot, monkeypatch, how):
    """Each shoots through the same stretches, eagerly: no photon/graph
    span, no capture, no graph table filled; shoot_batch_fn (diff.py's
    entry) never asks for graphs."""
    ro, scene = small_shoot
    if how == "shoot_batch_fn":
        monkeypatch.setattr(cuda_graphs, "graphs_for",
                            lambda *a: pytest.fail("graphs asked for"))
        B = 1024
        r, names, counters = _traced(lambda: shooter.shoot_batch_fn(scene, 5, True)(
            torch.arange(B), torch.full((B,), 4096), 3))
        assert r["pos"].shape == (B, 10, 3)
        _, names2, counters2 = _traced(lambda: diff.freeze_photon_shoot(
            scene, 2048, vol_quota=10, seed=2))
        assert names2.count("photon/graph") == 0 and not counters2
    else:
        if how == "autograd":
            params = diff.default_params(scene, want=("kd_scale",))
            scene = diff.apply_params(scene, params._replace(
                kd_scale=params.kd_scale.requires_grad_()))
            asked = []
            real = cuda_graphs.graphs_for
            monkeypatch.setattr(cuda_graphs, "graphs_for", lambda sc, cls, lanes, key: (
                asked.append(1) or real(sc, cls, _card_lane(lanes.shape[0]), key)))
        ctx, names, counters = _traced(lambda: _build(ro, scene))
        assert ctx.stats["batches"] == 2 and ctx.volume.count >= SHOOT_VOLUME_PHOTONS
        assert names.count("photon/batch") == 2
        if how == "autograd":
            assert asked == [1] and ctx.volume.alpha.requires_grad
    assert "photon/graph" not in names
    assert not any(k.startswith("photon/graph") for k in counters)
    assert not scene.graphs


def test_the_split_draws_are_integrator_uniform(scenes, monkeypatch):
    """Every (depth, dim) the stretches draw, from the batch's base,
    equals integrator_uniform at the batch's lane, shot base and seed,
    bit for bit, seeds past 32 bits included."""
    B = 512
    lane = torch.arange(B)
    drawn = set()
    real = shooter.integrator_uniform_at

    def recording(base, depth, dim):
        drawn.add((depth, dim))
        return real(base, depth, dim)

    monkeypatch.setattr(shooter, "integrator_uniform_at", recording)
    for name in ("rainbowc", "disp"):
        _, scene = scenes[name]
        shooter.shoot_batch_fn(scene, 5, scene.volume is not None)(
            lane, torch.full((B,), 8192), 1)
    monkeypatch.undo()
    assert {(0, k) for k in range(5)} <= drawn
    assert {(4, k) for k in (10, 17, 18, 20, 37)} <= drawn
    assert {(3, k) for k in (30, 35, 38)} <= drawn
    # the emission's 5; per depth 8 Woodcock, 3 scatter and the radiance
    # candidate's; per depth but the last 7 of the continuation
    assert len(drawn) == 5 + 5 * 12 + 4 * 7
    for seed in (0, 7, 2**31 + 5, 2**33 + 1):
        for shot_base in (0, 4096 * 63):
            base = shooter.integrator_base(lane, torch.full((B,), shot_base), seed)
            for depth, dim in sorted(drawn):
                assert torch.equal(real(base, depth, dim),
                                   integrator_uniform(lane, torch.full((B,), shot_base), depth,
                                                      dim, seed))


def _whole_batch(scene, max_depth, has_volume, lane, shot_base, seed):
    """shoot_batch_fn's batch as one function, as it was before the
    split: every draw hashes (lane, shot_base, seed) again."""
    from pbrt_tpu_torch.integrators.surface import make_frame

    S, BIG, C_NONE, C_DIRECT, C_CAUSTIC, C_INDIRECT, C_VOLUME = (
        spec.N_BINS, shooter.BIG, shooter.C_NONE, shooter.C_DIRECT, shooter.C_CAUSTIC,
        shooter.C_INDIRECT, shooter.C_VOLUME)
    world_c = torch.as_tensor(0.5 * (scene.world_lo + scene.world_hi), dtype=torch.float32)
    world_rad = float(np.linalg.norm(scene.world_hi - scene.world_lo) * 0.5) + 1e-3
    vol = scene.volume if has_volume else None
    sig_majorant = shooter.compute_majorant(scene, has_volume)
    y_norm = 1.0 / float(np.maximum(np.asarray(spec.y(np.ones((1, S), np.float32)))[0], 1e-12))
    disp = torch.cat([scene.material_dispersive.to(torch.int32), torch.zeros((1,), dtype=torch.int32)])
    B = lane.shape[0]
    zero = torch.zeros(())
    zf = torch.zeros((B,))

    def u(depth, dim):
        return integrator_uniform(lane, shot_base, depth, dim, seed)

    li, pmf = scene.light_dist.sample_discrete(u(0, 0))
    lr = sample_light_ray(scene.lights, li, world_c, world_rad, u(0, 1), u(0, 2), u(0, 3), u(0, 4))
    alpha = lr.alpha / torch.clamp(pmf, min=1e-12)[..., None]
    ray_o, ray_d = lr.o, lr.d
    alive = ~spec.is_black(alpha)
    specular_only = torch.ones((B,), dtype=torch.bool)
    n_inter = torch.zeros((B,), dtype=torch.int64)
    lam_nm = torch.full((B,), -1.0)
    rec = {k: [] for k in shooter.REC_KEYS}
    z3, zS, fB = torch.zeros((B, 3)), torch.zeros((B, S)), torch.zeros((B,), dtype=torch.bool)

    def record(*vals):
        for k, v in zip(rec, vals):
            rec[k].append(v)

    for depth in range(max_depth):
        hit = scene.intersect(Ray(ray_o, ray_d, zf, torch.where(alive, torch.full((), BIG),
                                                                torch.full((), -1.0)), zf))
        t_hit = torch.where(hit.valid, hit.t, torch.full((), BIG))
        if vol is not None:
            vhit, vt0, vt1 = vol_intersect_p(vol, ray_o, ray_d, zf, t_hit)
            t_try = vt0
            interacted = torch.zeros((B,), dtype=torch.bool)
            t_int = torch.full((B,), BIG)
            for wtrial in range(4):
                step = -torch.log(torch.clamp(u(depth, 10 + 2 * wtrial), min=1e-12)) / sig_majorant
                t_try = t_try + step
                inside = vhit & (t_try < vt1) & ~interacted & alive
                sa_t, ss_t, _, _ = sigma_at(vol, ray_o + t_try[..., None] * ray_d)
                sig_here = spec.y(sa_t + ss_t) * y_norm
                accept = inside & (u(depth, 11 + 2 * wtrial) * sig_majorant < sig_here)
                t_int = torch.where(accept & ~interacted, t_try, t_int)
                interacted = interacted | accept
            p_int = ray_o + t_int[..., None] * ray_d
            sa_i, ss_i, _, g_i = sigma_at(vol, p_int)
            albedo = spec.y(ss_i) / torch.clamp(spec.y(sa_i + ss_i), min=1e-12)
            store_vol = interacted & (n_inter >= 1)
            record(p_int, torch.where(store_vol[..., None], alpha, zero), -ray_d,
                   torch.where(store_vol, C_VOLUME, C_NONE), z3, zS, zS, fB)
            scatter = interacted & (u(depth, 18) > albedo)
            new_d = uniform_sample_sphere(u(depth, 19), u(depth, 20))
            w_scale = (vol_phase(g_i, -ray_d, new_d) * 4.0 * math.pi)[..., None]
            alpha = torch.where(scatter[..., None], alpha * w_scale, alpha)
            ray_o = torch.where(scatter[..., None], p_int, ray_o)
            ray_d_new = torch.where(scatter[..., None], new_d, ray_d)
            n_inter = n_inter + interacted.to(torch.int64)
            specular_only = specular_only & ~interacted
            alive = alive & ~(interacted & ~scatter)
            surface_lane = alive & hit.valid & ~interacted
            ray_d = ray_d_new
        else:
            interacted = fB
            surface_lane = alive & hit.valid
        lobes = material_lobes(eval_bsdf_params(scene, hit))
        n_inter_s = n_inter + surface_lane.to(torch.int64)
        store_surf = surface_lane & has_non_specular(lobes)
        cls = torch.where(store_surf & (n_inter_s == 1), C_DIRECT,
                          torch.where(store_surf & specular_only, C_CAUSTIC,
                                      torch.where(store_surf, C_INDIRECT, C_NONE)))
        n_ff = torch.where((dot(hit.ns, -ray_d) < 0.0)[..., None], -hit.ns, hit.ns)
        record(hit.p, torch.where(store_surf[..., None], alpha, zero), -ray_d, cls, n_ff,
               lobes.diff_r + lobes.gloss + lobes.spec_r, lobes.spec_t,
               store_surf & (u(depth, 37) < 0.125))
        if depth == max_depth - 1:
            break
        is_disp = disp[torch.clamp(hit.mat, 0, disp.shape[0] - 1)] > 0
        need_lam = surface_lane & is_disp & has_transmissive(lobes) & (lam_nm < 0)
        bin_idx, bin_w = spec.sample_bin(alpha, u(depth, 30))
        alpha = torch.where(need_lam[..., None],
                            alpha * spec.one_hot(bin_idx) * bin_w[..., None], alpha)
        lam_nm = torch.where(need_lam, spec.bin_wavelength(bin_idx), lam_nm)
        frame = make_frame(hit)
        bs = bsdf_sample(lobes, frame, -normalize(ray_d), u(depth, 31), u(depth, 32),
                         u(depth, 33), u(depth, 34), lam_nm=lam_nm, u_pick=u(depth, 38))
        cos_i = torch.abs(dot(bs.wi, frame.ns))
        anew = alpha * bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[..., None]
        cont_p = torch.clamp(spec.y(anew) / torch.clamp(spec.y(alpha), min=1e-12), 0.0, 1.0)
        cont_p = torch.where(cont_p > 0.0, torch.clamp(cont_p, min=0.1), zero)
        survive = u(depth, 35) < cont_p
        anew = anew / torch.clamp(cont_p, min=1e-9)[..., None]
        new_alive_s = surface_lane & bs.valid & survive & ~spec.is_black(anew)
        vol_cont = interacted & alive
        alpha = torch.where(new_alive_s[..., None], anew, alpha)
        ray_o = torch.where(new_alive_s[..., None], hit.p + bs.wi * shooter.RAY_EPS, ray_o)
        ray_d = torch.where(new_alive_s[..., None], bs.wi, ray_d)
        specular_only = specular_only & torch.where(surface_lane, bs.is_specular, True)
        n_inter = n_inter_s
        alive = vol_cont | new_alive_s
    return {k: torch.stack(v, 1) for k, v in rec.items()}


@pytest.mark.parametrize("name", ["rainbowc", "disp"])
def test_the_stretches_are_the_whole_batch(scenes, name):
    """shoot_batch_fn (the stretches, eagerly) and the stretches fed
    through a ShootGraphs' static buffers (a key that fell back: every
    stretch eager, the base and each hit copied in) give every record of
    the whole batch, bit for bit, at two shot bases."""
    _, scene = scenes[name]
    hv = scene.volume is not None
    B = 1024
    lane = torch.arange(B)
    graphs = shooter.ShootGraphs(torch.device("cpu"), shooter.Shooter(scene, 5, hv))
    graphs.failed = True
    for shot_base, seed in ((4096, 3), (4096 * 40, 2**31 + 11)):
        sb = torch.full((B,), shot_base)
        whole = _whole_batch(scene, 5, hv, lane, sb, seed)
        split = shooter.shoot_batch_fn(scene, 5, hv)(lane, sb, seed)
        buffered = graphs.shooter.shoot(graphs.put("base", shooter.integrator_base(lane, sb, seed)),
                                        graphs)
        assert whole["cls"].shape == (B, 10 if hv else 5)
        assert int((whole["cls"] > 0).sum()) > 0
        for k in shooter.REC_KEYS:
            assert _bit_equal(split[k], whole[k]), k
            assert _bit_equal(buffered[k], whole[k]), k
    assert {"base", "hit0.p", "hit4.p"} <= set(graphs.bufs) and not graphs.graphs
