"""PhotonVolume integrator: ray-marched single scattering + volume
photon-map multiple scattering + the RainbowVolume transfer.

Port of pbrt_tpu/integrators/photonvolume.py (reference integrators/
photonvolume.cpp:112-222). Per march step i over the volume span
[t0, t1], one Python loop iteration:

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
from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu
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
    u0 = iu(pixel, sidx, 0, 60, seed)
    L = torch.zeros((N, S), device=dev)
    tr = ones
    active = torch.ones((N,), dtype=torch.bool, device=dev)
    for i in range(n_steps):
        with probes.scope("volume/march_step"):
            t = t0 + (i + u0) * dt
            p = ray.o + t[..., None] * d
            sa, ss, le, g = sigma_at(vol, p)
            # the step's optical depth over [t - dt, t] (reference tauRay)
            tr = torch.where(active[..., None], torch.exp(-(sa + ss) * dt[..., None]), tr)
            in_rainbow = rainbow_mask(vol, p)

            # single scattering from one light (:177-203)
            Ld = torch.zeros((N, S), device=dev)
            if scene.n_lights > 0:
                light_idx, pmf = scene.light_dist.sample_discrete(iu(pixel, sidx, i, 61, seed))
                ls = sample_light(scene.lights, light_idx, p, iu(pixel, sidx, i, 62, seed),
                                  iu(pixel, sidx, i, 63, seed))
                occ = _shadow(scene, p, ls.wi, ls.dist, hit & active)
                tr_light = transmittance(vol, p, ls.wi, ls.dist, max(4, n_steps // 4),
                                         iu(pixel, sidx, i, 64, seed))
                Ld_raw = ls.L * tr_light / torch.clamp(ls.pdf * pmf, min=1e-12)[..., None]
                # rainbow: the angle -> wavelength transfer replaces the
                # phase-weighted term (:196-198); wo = -d, toward the eye
                Ld = torch.where(in_rainbow[..., None], rainbow_reflection(Ld_raw, d, ls.wi),
                                 Ld_raw * vol_phase(g, d, ls.wi)[..., None])
                Ld = torch.where((hit & ~occ & active)[..., None], Ld, zero)

            # multiple scattering from the volume photon map (:205-213)
            want = hit & active & ~in_rainbow
            Lii, enough = lphoton_volume(ctx.volume, p, d, g, ctx.vol_n_used, ctx.vol_max_dist2,
                                         mask=want)
            Lii = Lii / torch.clamp(torch.sum(ss, -1) / S, min=1e-9)[..., None]
            albedo = ss / torch.clamp(sa + ss, min=1e-9)
            Lii_term = torch.where((enough & want)[..., None], albedo * Lii, zero)

            # Lv = sa Lve dt + ss (Ld + albedo Lii) dt + Tr Lv  (:215)
            src = (sa * le + ss * (Ld + Lii_term)) * dt[..., None]
            L = torch.where(active[..., None], src + tr * L, L)
            # the march stops where the step's transmittance falls below
            # 1e-3 (reference :158-165 Russian-roulettes there; the lockstep
            # lanes stop with Tr = 0, within 1e-3 of it in expectation)
            cut = active & (spec.y(tr) < 1e-3)
            tr = torch.where(cut[..., None], zero, tr)
            active = active & ~cut
    return VolResult(L=torch.where(hit[..., None], L, zero),
                     Tr=torch.where(hit[..., None], tr, ones))
