"""PhotonVolume integrator: ray-marched single scattering + volume
photon-map multiple scattering + the RainbowVolume transfer.

Port of pbrt_tpu/integrators/photonvolume.py (reference integrators/
photonvolume.cpp:112-222). Per march step i over the volume span
[t0, t1]:

  Tr_i   the step's own transmittance exp(-sigma_t dt) (:154-165)
  L_d    single scattering from one light with surface occlusion and
         medium transmittance (:177-203); inside rainbow regions the
         phase-weighted term is replaced by rainbowReflection (:196-198)
  L_ii   multiple scattering from the volume photon map:
         sum(flux x phase) / ((4/3) pi r^3 sigma_s), r the found set's
         radius, at least 10 photons (:65-108); skipped inside rainbow
         regions (:205-207)
  Lv     = (sigma_a Lve + sigma_s (L_d + albedo L_ii)) dt + Tr_i Lv (:215)

and a lane stops (Tr = 0) once the step's y(Tr) falls below 1e-3, where
the reference Russian-roulettes the march.

A step's point, draws, Tr_i, L_d and L_ii depend on no other step: only
the stop and the fold of Lv carry from step to step. So the march runs
in chunks of whole steps: one pass computes every (step, lane) of a
chunk at once (one shadow traversal, one transmittance, one kNN), the
lanes still marching at each step come from an exact prefix of the
chunk's stop flags, and the fold then runs step by step. Every lane's
arithmetic is the step loop's, in its order. A chunk's steps are sized
from the bytes its temporaries take, as photon/map.py sizes its query
blocks.
"""
from __future__ import annotations

import math

import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.sampling import phase_hg
from pbrt_tpu_torch.core.transform import xform_point_affine
from pbrt_tpu_torch.integrators.volume import VolResult, _march_span, _shadow, transmittance
from pbrt_tpu_torch.lights.lighting import sample_light
from pbrt_tpu_torch.photon import map as pmap
from pbrt_tpu_torch.samplers.samplers import integrator_base
from pbrt_tpu_torch.samplers.samplers import integrator_uniform_at as iu_at
from pbrt_tpu_torch.volumes.registry import V_RAINBOW, rainbow_reflection, sigma_at
from pbrt_tpu_torch.volumes.registry import phase as vol_phase

S = spec.N_BINS


def rainbow_mask(vol, p):
    """True where p lies inside any rainbow region."""
    m = torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device)
    for vi, kind in enumerate(vol.host_kind):
        if kind == V_RAINBOW:
            pv = xform_point_affine(vol.w2v[vi], p)
            m = m | torch.all((pv >= vol.lo[vi]) & (pv <= vol.hi[vi]), -1)
    return m


def lphoton_volume(pm, p, w, g, n_used: int, max_dist2: float, mask=None):
    """Volume radiance estimate (reference photonvolume.cpp:65-108): kNN
    flux x phase over (4/3) pi r^3, r the found set's largest distance
    (its maxmd, not the shrunk kd radius); sigma_s is the caller's. ->
    ([N, S], enough [N]: at least 10 photons)."""
    if pm is None:
        return (torch.zeros(p.shape[:-1] + (S,), device=p.device),
                torch.zeros(p.shape[:-1], dtype=torch.bool, device=p.device))

    def weight(wix, wiy, wiz, d2, valid, r2, wq, gq):
        return phase_hg(wix * wq[:, 0:1] + wiy * wq[:, 1:2] + wiz * wq[:, 2:3], gq[:, None])

    res = pmap.knn_weighted_flux(pm, p, n_used, max_dist2, weight, extras=(w, g), mask=mask)
    r3 = torch.pow(torch.clamp(res.r2_found, min=1e-12), 1.5)
    return res.flux * (1.0 / ((4.0 / 3.0) * math.pi * r3))[..., None], res.n_found >= 10


# A chunk's temporaries: about 24 [S] float32 rows a (step, lane) at the
# pass's peak (sigma_a, sigma_s, Le, Tr, the light sample, its
# transmittance and transfer, the kNN estimate, the source term and
# their intermediates), budgeted as photon/map.py budgets a query block.
MARCH_BUDGET_CUDA = 2 << 30   # bytes of a chunk's temporaries, at most
MARCH_BUDGET_CPU = 64 << 20
LANE_STEP_BYTES = 24 * 4 * S


def chunk_steps(n_lanes: int, n_steps: int, device) -> int:
    """Steps a chunk, from the bytes one (step, lane) takes: one card
    memory reading a march."""
    if torch.device(device).type == "cuda":
        free, _ = torch.cuda.mem_get_info(torch.device(device))
        budget = min(MARCH_BUDGET_CUDA, free // 16)
    else:
        budget = MARCH_BUDGET_CPU
    return int(max(1, min(n_steps, budget // max(1, n_lanes * LANE_STEP_BYTES))))


def _march_chunk(scene, ctx, ray_o, d, hit, t0, dt, u0, base, i0: int, C: int, active,
                 n_steps: int):
    """Steps i0 .. i0 + C - 1 of every lane in one pass over C x N
    points. -> (tr [C, N, S] each step's own transmittance, src [C, N, S]
    each step's source term, act [C, N] the lanes marching at each step,
    active [N] those still marching after the chunk)."""
    vol = scene.volume
    N = ray_o.shape[0]
    dev = ray_o.device
    zero = torch.zeros((), device=dev)
    step = torch.arange(i0, i0 + C, device=dev)[:, None]             # [C, 1]
    t = t0 + (step.to(torch.float32) + u0) * dt                      # [C, N]
    p = (ray_o + t[..., None] * d).reshape(C * N, 3)
    dl = d.expand(C, N, 3).reshape(C * N, 3)
    dtl = dt.expand(C, N).reshape(C * N, 1)
    sa, ss, le, g = sigma_at(vol, p)
    # the step's optical depth over [t - dt, t] (reference tauRay)
    tr = torch.exp(-(sa + ss) * dtl)
    # the march stops after the step whose transmittance falls below
    # 1e-3 (reference :158-165 Russian-roulettes there; the lockstep
    # lanes stop with Tr = 0, within 1e-3 of it in expectation): a lane
    # marches at step i while it was marching at the chunk's start and
    # no earlier step of the chunk stopped it
    keep = ~(spec.y(tr) < 1e-3).reshape(C, N)
    run = torch.cumprod(keep.to(torch.int32), 0) > 0
    act = torch.cat([active[None], active[None] & run[:-1]])
    live = (hit & act).reshape(C * N)
    in_rainbow = rainbow_mask(vol, p)

    def draw(dim):
        return iu_at(base, step, dim).reshape(C * N)

    # single scattering from one light (:177-203)
    Ld = torch.zeros((C * N, S), device=dev)
    if scene.n_lights > 0:
        light_idx, pmf = scene.light_dist.sample_discrete(draw(61))
        ls = sample_light(scene.lights, light_idx, p, draw(62), draw(63))
        occ = _shadow(scene, p, ls.wi, ls.dist, live)
        tr_light = transmittance(vol, p, ls.wi, ls.dist, max(4, n_steps // 4), draw(64))
        Ld_raw = ls.L * tr_light / torch.clamp(ls.pdf * pmf, min=1e-12)[..., None]
        # rainbow: the angle -> wavelength transfer replaces the
        # phase-weighted term (:196-198); wo = -d, toward the eye
        Ld = torch.where(in_rainbow[..., None], rainbow_reflection(Ld_raw, dl, ls.wi),
                         Ld_raw * vol_phase(g, dl, ls.wi)[..., None])
        Ld = torch.where((live & ~occ)[..., None], Ld, zero)

    # multiple scattering from the volume photon map (:205-213)
    want = live & ~in_rainbow
    Lii, enough = lphoton_volume(ctx.volume, p, dl, g, ctx.vol_n_used, ctx.vol_max_dist2,
                                 mask=want)
    Lii = Lii / torch.clamp(torch.sum(ss, -1) / S, min=1e-9)[..., None]
    albedo = ss / torch.clamp(sa + ss, min=1e-9)
    Lii_term = torch.where((enough & want)[..., None], albedo * Lii, zero)

    # the step's source term sa Lve dt + ss (Ld + albedo Lii) dt  (:215)
    src = (sa * le + ss * (Ld + Lii_term)) * dtl
    return tr.reshape(C, N, S), src.reshape(C, N, S), act, act[-1] & keep[-1]


@probes.spanned("volume/march")
def li_photonvolume(scene, ctx, ray, t_surf, pixel, sidx, n_steps: int,
                    seed: int = 0) -> VolResult:
    vol = scene.volume
    N = ray.o.shape[0]
    dev = ray.o.device
    zero = torch.zeros((), device=dev)
    ones = torch.ones((N, S), device=dev)
    if vol is None:
        return VolResult(L=torch.zeros((N, S), device=dev), Tr=ones)
    d, hit, t0, t1 = _march_span(vol, ray, t_surf)
    dt = torch.clamp(t1 - t0, min=0.0) / n_steps
    base = integrator_base(pixel, sidx, seed)
    u0 = iu_at(base, 0, 60)
    L = torch.zeros((N, S), device=dev)
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    C = chunk_steps(N, n_steps, dev)
    for i0 in range(0, n_steps, C):
        c = min(C, n_steps - i0)
        with probes.scope("volume/march_chunk"):
            tr, src, act, active = _march_chunk(scene, ctx, ray.o, d, hit, t0, dt, u0, base,
                                                i0, c, active, n_steps)
        probes.count("volume/march_chunks")
        # Lv = src + Tr Lv, step by step (:215)
        for j in range(c):
            with probes.scope("volume/march_step"):
                L = torch.where(act[j][..., None], src[j] + tr[j] * L, L)
    # a stopped lane returns Tr = 0, one still marching its last step's
    tr = torch.where(active[..., None], tr[-1], zero)
    return VolResult(L=torch.where(hit[..., None], L, zero),
                     Tr=torch.where(hit[..., None], tr, ones))
