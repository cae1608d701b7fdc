"""Wavefront volume integrators: emission + single scattering.

Port of pbrt_tpu/integrators/volume.py (reference integrators/
emission.cpp:64-110 and single.cpp:66-140). The reference marches each
ray with a dynamic step count ceil((t1-t0)/stepsize); here every ray
marches a fixed n_steps with its own dt = (t1-t0)/n_steps, n_steps
chosen once per scene from the volume extent / stepsize so the expected
step length matches the reference's. The march is a Python loop over
that count: one set of tensor operations per step.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import warning
from pbrt_tpu_torch.core.geometry import Ray, normalize
from pbrt_tpu_torch.lights.lighting import sample_light
from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu
from pbrt_tpu_torch.volumes.registry import VolumeT, intersect_p as vol_intersect_p
from pbrt_tpu_torch.volumes.registry import phase, sigma_at, tau as vol_tau

S = spec.N_BINS
BIG = 1e30


def pick_n_steps(vol: VolumeT, step_size: float, cap: int = 128) -> int:
    """Static march count ~ volume diagonal / stepsize, clamped to
    [4, cap]. The cap is the reference package's (its quirk R1: silent
    there); a warning says when it coarsens the authored stepsize."""
    diag = float(np.max(np.linalg.norm((vol.hi - vol.lo).cpu().numpy(), axis=-1)))
    want = int(np.ceil(diag / max(step_size, 1e-6)))
    n = int(np.clip(want, 4, cap))
    if want > cap:
        warning(f'VolumeIntegrator "stepsize" {step_size:g} asks for {want} march steps '
                f"over the volume's diagonal {diag:g}; capped at {cap} (steps of "
                f"{diag / cap:g})")
    return n


@probes.spanned("volume/transmittance")
def transmittance(vol: Optional[VolumeT], p, w, dist, n_steps: int, u):
    """Beam transmittance between p and p + w*dist (reference
    emission.cpp Transmittance -> Exp(-tau)). [N, S]."""
    if vol is None:
        return torch.ones(p.shape[:-1] + (S,), device=p.device)
    d = normalize(w)
    dd = torch.where(dist >= BIG, torch.full((), 1e7, device=p.device), dist)
    hit, t0, t1 = vol_intersect_p(vol, p, d, torch.zeros_like(dd), dd)
    t = vol_tau(vol, p, d, t0, t1, n_steps, u)
    return torch.where(hit[..., None], torch.exp(-t), torch.ones((), device=p.device))


class VolResult(NamedTuple):
    L: torch.Tensor   # [N, S] in-scattered/emitted radiance
    Tr: torch.Tensor  # [N, S] transmittance along the surface-hit span


def _march_span(vol: VolumeT, ray: Ray, t_surf):
    """Unit direction and the volume span [t0, t1] before the surface."""
    N = ray.o.shape[0]
    d = normalize(ray.d)
    scale = torch.sqrt(torch.clamp(torch.sum(ray.d * ray.d, -1), min=1e-20))
    t_end = torch.where(torch.isfinite(t_surf), t_surf * scale,
                        torch.full((), 1e7, device=ray.o.device))
    hit, t0, t1 = vol_intersect_p(vol, ray.o, d, torch.zeros((N,), device=ray.o.device), t_end)
    return d, hit, t0, t1


@probes.spanned("volume/march")
def li_emission(vol: Optional[VolumeT], ray: Ray, t_surf, pixel, sidx,
                n_steps: int, seed: int = 0) -> VolResult:
    """Emission-only integrator (reference emission.cpp:64-110)."""
    N = ray.o.shape[0]
    dev = ray.o.device
    ones = torch.ones((N, S), device=dev)
    if vol is None:
        return VolResult(L=torch.zeros((N, S), device=dev), Tr=ones)
    d, hit, t0, t1 = _march_span(vol, ray, t_surf)
    dt = torch.clamp(t1 - t0, min=0.0) / n_steps
    u0 = iu(pixel, sidx, 0, 40, seed)
    L = torch.zeros((N, S), device=dev)
    tau_acc = torch.zeros((N, S), device=dev)
    for i in range(n_steps):
        with probes.scope("volume/march_step"):
            t = t0 + (i + u0) * dt
            sa, ss, le, _ = sigma_at(vol, ray.o + t[..., None] * d)
            tau_acc = tau_acc + (sa + ss) * dt[..., None]
            L = L + torch.exp(-tau_acc) * sa * le * dt[..., None]
    Tr = torch.where(hit[..., None], torch.exp(-tau_acc), ones)
    return VolResult(L=torch.where(hit[..., None], L, torch.zeros((), device=dev)), Tr=Tr)


@probes.spanned("volume/march")
def li_single(scene, ray: Ray, t_surf, pixel, sidx, n_steps: int, seed: int = 0) -> VolResult:
    """Single-scattering integrator (reference single.cpp:66-140):
    march; per step accumulate emission + sigma_s * phase * Ld from one
    sampled light, attenuated by the transmittance to the light."""
    vol = scene.volume
    N = ray.o.shape[0]
    dev = ray.o.device
    ones = torch.ones((N, S), device=dev)
    zero = torch.zeros((), device=dev)
    if vol is None:
        return VolResult(L=torch.zeros((N, S), device=dev), Tr=ones)
    d, hit, t0, t1 = _march_span(vol, ray, t_surf)
    dt = torch.clamp(t1 - t0, min=0.0) / n_steps
    u0 = iu(pixel, sidx, 0, 40, seed)
    L = torch.zeros((N, S), device=dev)
    tau_acc = torch.zeros((N, S), device=dev)
    for i in range(n_steps):
        with probes.scope("volume/march_step"):
            t = t0 + (i + u0) * dt
            p = ray.o + t[..., None] * d
            sa, ss, le, g = sigma_at(vol, p)
            tau_acc = tau_acc + (sa + ss) * dt[..., None]
            tr = torch.exp(-tau_acc)
            L = L + tr * sa * le * dt[..., None]
            if scene.n_lights > 0:
                light_idx, pmf = scene.light_dist.sample_discrete(iu(pixel, sidx, i, 41, seed))
                ls = sample_light(scene.lights, light_idx, p, iu(pixel, sidx, i, 42, seed),
                                  iu(pixel, sidx, i, 43, seed))
                # occlusion by surfaces + attenuation through the medium
                occ = _shadow(scene, p, ls.wi, ls.dist, hit)
                tr_light = transmittance(vol, p, ls.wi, ls.dist, max(4, n_steps // 4),
                                         iu(pixel, sidx, i, 44, seed))
                ph = phase(g, -d, ls.wi)
                contrib = (ss * tr * tr_light * ls.L
                           * (ph / torch.clamp(ls.pdf * pmf, min=1e-12))[..., None]
                           * dt[..., None])
                L = L + torch.where((hit & ~occ)[..., None], contrib, zero)
    Tr = torch.where(hit[..., None], torch.exp(-tau_acc), ones)
    return VolResult(L=torch.where(hit[..., None], L, zero), Tr=Tr)


def _shadow(scene, p, wi, dist, valid):
    """Any-hit shadow ray from a march point toward a light sample."""
    N = p.shape[0]
    dev = p.device
    tmax = torch.where(dist >= BIG, torch.full((), BIG, device=dev), dist * (1.0 - 1e-3))
    ray = Ray(o=p + wi * 1e-3, d=wi, tmin=torch.zeros((N,), device=dev),
              tmax=torch.where(valid, tmax, torch.full((), -1.0, device=dev)),
              time=torch.zeros((N,), device=dev))
    return scene.intersect_p(ray, coherent=True)
