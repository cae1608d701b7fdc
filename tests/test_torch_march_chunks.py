"""The photon-volume march in chunks of steps
(integrators/photonvolume.py li_photonvolume) against the step loop it
replaced, which this file keeps as the reference (`step_loop`): L and Tr
equal bit for bit.

Scenes: tests/photon_scenes.py's PHOTON_SCENE (12 march
steps; a volume photon map made with NumPy from a seed, so the kNN has
live queries; part of the rays cross the rainbow region), at chunks of 1
step, of 5 + 5 + 2 and of all 12; the same scene with a dense slab,
where the 1e-3 stop fires mid-march, on both sides of a chunk boundary;
and a 32 x 32 crop of the `rainbowc` golden at 2 spp (128 steps), every
march of the render held against the loop on the same inputs. The file
imports nothing of JAX: the card's tests (tests/test_torch_gpu.py) use
its step loop.
"""
import os
import re

import numpy as np
import pytest
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.integrators import photonvolume as t_pv
from pbrt_tpu_torch.integrators.volume import VolResult, _march_span, _shadow, transmittance
from pbrt_tpu_torch.lights.lighting import sample_light
from pbrt_tpu_torch.photon import map as pmap
from pbrt_tpu_torch.photon.shooter import PhotonCtx
from pbrt_tpu_torch.renderers import driver
from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu
from pbrt_tpu_torch.scene import api, parser
from pbrt_tpu_torch.scene.compile import compile_scene
from pbrt_tpu_torch.volumes.registry import rainbow_reflection, sigma_at
from pbrt_tpu_torch.volumes.registry import phase as vol_phase
from photon_scenes import PHOTON_SCENE

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
S = spec.N_BINS
N = 256
STEPS = 12
# a slab of dense medium across the middle of the march: a step inside
# it has Tr ~ exp(-20), below the stop's 1e-3
DENSE_SLAB = """Volume "homogeneous" "point p0" [-3 -0.6 -1.5] "point p1" [3 3 0.5]
  "rgb sigma_a" [10 10 10] "rgb sigma_s" [30 30 30]
WorldEnd"""


def step_loop(scene, ctx, ray, t_surf, pixel, sidx, n_steps: int, seed: int = 0):
    """li_photonvolume as one Python iteration a step: the reference.
    -> (VolResult, the step at which each lane stopped, -1 if none)."""
    vol = scene.volume
    N = ray.o.shape[0]
    dev = ray.o.device
    zero = torch.zeros((), device=dev)
    ones = torch.ones((N, S), device=dev)
    d, hit, t0, t1 = _march_span(vol, ray, t_surf)
    dt = torch.clamp(t1 - t0, min=0.0) / n_steps
    u0 = iu(pixel, sidx, 0, 60, seed)
    L = torch.zeros((N, S), device=dev)
    tr = ones
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    stopped_at = torch.full((N,), -1, dtype=torch.int64, device=dev)
    for i in range(n_steps):
        t = t0 + (i + u0) * dt
        p = ray.o + t[..., None] * d
        sa, ss, le, g = sigma_at(vol, p)
        tr = torch.where(active[..., None], torch.exp(-(sa + ss) * dt[..., None]), tr)
        in_rainbow = t_pv.rainbow_mask(vol, p)
        Ld = torch.zeros((N, S), device=dev)
        if scene.n_lights > 0:
            light_idx, pmf = scene.light_dist.sample_discrete(iu(pixel, sidx, i, 61, seed))
            ls = sample_light(scene.lights, light_idx, p, iu(pixel, sidx, i, 62, seed),
                              iu(pixel, sidx, i, 63, seed))
            occ = _shadow(scene, p, ls.wi, ls.dist, hit & active)
            tr_light = transmittance(vol, p, ls.wi, ls.dist, max(4, n_steps // 4),
                                     iu(pixel, sidx, i, 64, seed))
            Ld_raw = ls.L * tr_light / torch.clamp(ls.pdf * pmf, min=1e-12)[..., None]
            Ld = torch.where(in_rainbow[..., None], rainbow_reflection(Ld_raw, d, ls.wi),
                             Ld_raw * vol_phase(g, d, ls.wi)[..., None])
            Ld = torch.where((hit & ~occ & active)[..., None], Ld, zero)
        want = hit & active & ~in_rainbow
        Lii, enough = t_pv.lphoton_volume(ctx.volume, p, d, g, ctx.vol_n_used,
                                          ctx.vol_max_dist2, mask=want)
        Lii = Lii / torch.clamp(torch.sum(ss, -1) / S, min=1e-9)[..., None]
        albedo = ss / torch.clamp(sa + ss, min=1e-9)
        Lii_term = torch.where((enough & want)[..., None], albedo * Lii, zero)
        src = (sa * le + ss * (Ld + Lii_term)) * dt[..., None]
        L = torch.where(active[..., None], src + tr * L, L)
        cut = active & (spec.y(tr) < 1e-3)
        tr = torch.where(cut[..., None], zero, tr)
        active = active & ~cut
        stopped_at = torch.where(cut, i, stopped_at)
    return (VolResult(L=torch.where(hit[..., None], L, zero),
                      Tr=torch.where(hit[..., None], tr, ones)), stopped_at)


def assert_bitwise(got, ref):
    for name in ("L", "Tr"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            f"{name}: {int((a != b).sum())} values differ, most {float((a - b).abs().max())}"


def compiled(tmp_path, text):
    path = tmp_path / "scene.pbrt"
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
    return compile_scene(kept["ro"], "cpu")


def volume_ctx(seed=0, device="cpu"):
    """A volume photon map over the medium, from a seed."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform([-3, -0.5, -3], [3, 3, 2], (6000, 3)).astype(np.float32)
    wi = rng.normal(size=(6000, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    alpha = rng.uniform(0, 1e-3, (6000, S)).astype(np.float32)
    vm = pmap.build_photon_map(pos, alpha, wi, 0.6, target_k=30, device=device)
    return PhotonCtx(caustic=None, indirect=None, volume=vm, direct=None, radiance=None,
                     n_caustic_paths=0, n_indirect_paths=0, n_volume_paths=10000, n_used=40,
                     max_dist2=0.16, vol_n_used=30, vol_max_dist2=0.36, final_gather=False,
                     gather_samples=0, cos_gather_angle=1.0, max_specular_depth=5,
                     max_photon_depth=5)


def camera_rays(scene, device="cpu"):
    """N rays from the camera over the floor, the wall, the sphere and
    the rainbow region, with their first surface hit."""
    rng = np.random.RandomState(5)
    target = rng.uniform([-2.5, -0.5, -1.5], [2.5, 2.8, 2.0], (N, 3))
    target[64:128, 1] = -0.5
    o = np.tile([[0.0, 1.2, -5.0]], (N, 1))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    z = torch.zeros(N, device=device)
    ray = Ray(torch.as_tensor(o, dtype=torch.float32, device=device),
              torch.as_tensor(d, dtype=torch.float32, device=device), z,
              torch.full((N,), 1e30, device=device), z)
    t_surf, _ = driver.first_hit_t(scene, ray)
    pixel = torch.arange(N, dtype=torch.int64, device=device) * 7 + 3
    return ray, t_surf, pixel, torch.zeros(N, dtype=torch.int64, device=device)


@pytest.fixture(scope="module")
def photon_scene(tmp_path_factory):
    return compiled(tmp_path_factory.mktemp("photon"), PHOTON_SCENE)


@pytest.fixture(scope="module")
def dense_scene(tmp_path_factory):
    return compiled(tmp_path_factory.mktemp("dense"), PHOTON_SCENE.replace("WorldEnd", DENSE_SLAB))


def chunked(monkeypatch, scene, ctx, args, steps_a_chunk):
    """li_photonvolume with the budget set to `steps_a_chunk` steps of N
    lanes, under spans: (result, chunks counted, march_step and
    march_chunk spans)."""
    monkeypatch.setattr(t_pv, "MARCH_BUDGET_CPU", steps_a_chunk * N * t_pv.LANE_STEP_BYTES)
    assert t_pv.chunk_steps(N, STEPS, "cpu") == min(steps_a_chunk, STEPS)
    probes.reset()
    probes.enable(True)
    try:
        got = t_pv.li_photonvolume(scene, ctx, *args, STEPS, seed=2)
        names = [s.name for s in probes.spans()]
        counted = probes.counters().get("volume/march_chunks", 0)
    finally:
        probes.enable(False)
        probes.reset()
    return got, counted, names.count("volume/march_step"), names.count("volume/march_chunk")


@pytest.mark.parametrize("steps_a_chunk,chunks", [(1, 12), (5, 3), (12, 1)])
def test_chunks_equal_the_step_loop(monkeypatch, photon_scene, steps_a_chunk, chunks):
    ctx = volume_ctx()
    args = camera_rays(photon_scene)
    ref, stopped_at = step_loop(photon_scene, ctx, *args, STEPS, seed=2)
    got, counted, n_step, n_chunk = chunked(monkeypatch, photon_scene, ctx, args, steps_a_chunk)
    assert_bitwise(got, ref)
    assert counted == n_chunk == chunks and n_step == STEPS
    # the kNN found photons, and some lanes march through the rainbow
    assert float(ref.L.sum()) > 0 and bool((stopped_at < 0).all())
    p = args[0].o + 4.0 * args[0].d
    in_rainbow = t_pv.rainbow_mask(photon_scene.volume, p)
    assert bool(in_rainbow.any()) and not bool(in_rainbow.all())


@pytest.mark.parametrize("steps_a_chunk,chunks", [(1, 12), (5, 3), (12, 1)])
def test_the_stop_across_chunk_boundaries(monkeypatch, dense_scene, steps_a_chunk, chunks):
    ctx = volume_ctx(1)
    args = camera_rays(dense_scene)
    ref, stopped_at = step_loop(dense_scene, ctx, *args, STEPS, seed=2)
    got, counted, n_step, n_chunk = chunked(monkeypatch, dense_scene, ctx, args, steps_a_chunk)
    assert_bitwise(got, ref)
    assert counted == n_chunk == chunks and n_step == STEPS
    # lanes stop at several steps, on both sides of the 5 + 5 split, and
    # some march to the end
    steps = set(stopped_at.tolist())
    assert {-1, 4, 5} <= steps and len(steps) >= 5
    assert bool((ref.Tr[stopped_at >= 0] == 0).all())


def test_rainbowc_crop_equals_the_step_loop(monkeypatch, tmp_path):
    """A 32 x 32 crop of rainbowc at 2 spp (one tile, 128 steps; 200
    volume photons, so the shoot is short): each march of the render,
    chunked at the CPU's budget, equals the loop on its inputs."""
    with open(os.path.join(GOLDENS, "rainbowc.pbrt")) as f:
        text = f.read().replace('"integer volumephotons"  [5000]', '"integer volumephotons" [200]')
    text = re.sub(r'(Film "image"[^\n]*)', r'\1 "float cropwindow" [0.25 0.5833333 0.25 0.5833333]',
                  text)
    assert '"integer volumephotons" [200]' in text
    path = tmp_path / "rainbowc.pbrt"
    path.write_text(text)
    march = t_pv.li_photonvolume
    checked = []

    def both(scene, ctx, ray, t_surf, pixel, sidx, n_steps, seed=0):
        got = march(scene, ctx, ray, t_surf, pixel, sidx, n_steps, seed)
        ref, _ = step_loop(scene, ctx, ray, t_surf, pixel, sidx, n_steps, seed)
        assert_bitwise(got, ref)
        checked.append((ray.o.shape[0], n_steps, t_pv.chunk_steps(ray.o.shape[0], n_steps,
                                                                   "cpu")))
        return got

    monkeypatch.setattr(t_pv, "li_photonvolume", both)
    api.pbrt_init({"quiet": True, "write": False, "device": "cpu", "tile_samples": 32 * 32 * 2})
    try:
        parser.parse_file(str(path))
        img = np.asarray(api._state.output)
    finally:
        api._state.__init__()
    assert img.shape == (32, 32, 3) and np.all(np.isfinite(img)) and img.mean() > 0
    # one tile of 2,048 lanes, 128 steps in chunks of 11 (64 MiB)
    assert checked == [(2048, 128, 11)]
