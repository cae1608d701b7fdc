"""Wavefront path integrator.

Port of the "path" integrator of pbrt_tpu/integrators/surface.py
(reference integrators/path.cpp:52-123): a fixed-depth loop over ray
batches with alive masks. Per vertex one light is sampled by the power
CDF (estimate_direct) and the BSDF continuation sample is reused as the
second MIS strategy: emission found at the next vertex is weighted by
power_heuristic(bsdf_pdf, light_pdf).

Spectral dispersion: lanes carry lam_nm (< 0 means dense spectrum). The
first dispersive specular transmission importance-samples ONE
wavelength bin from the throughput (spectrum.sample_bin); it is
committed only when the sampled lobe really transmits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import Ray, coordinate_system, cross, dot, normalize
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.accel.intersect import Hit
from pbrt_tpu_torch.lights.lighting import area_emission, area_tri_pdf, sample_light
from pbrt_tpu_torch.materials.bsdf import (
    Frame,
    Lobes,
    bsdf_f,
    bsdf_pdf,
    bsdf_sample,
    has_non_specular,
    material_lobes,
)
from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu

S = spec.N_BINS
BIG = 1e30
RAY_EPS = 1e-3


def make_frame(hit: Hit) -> Frame:
    ss = normalize(hit.dpdu)
    # re-orthogonalize against ns
    ss = normalize(ss - hit.ns * dot(ss, hit.ns)[..., None])
    degen = torch.sum(ss * ss, -1) < 0.5
    fb1, _ = coordinate_system(hit.ns)
    ss = torch.where(degen[..., None], fb1, ss)
    ts = cross(hit.ns, ss)
    return Frame(ss=ss, ts=ts, ns=hit.ns, ng=hit.ng)


def _occluded(scene, p, wi, dist, valid, time=None):
    """Shadow-ray query toward a light sample."""
    R = p.shape[0]
    dev = p.device
    big = torch.full((), BIG, device=dev)
    tmax = torch.where(dist >= BIG, big, dist * (1.0 - 1e-3))
    ray = Ray(
        o=p + wi * RAY_EPS,
        d=wi,
        tmin=torch.zeros((R,), device=dev),
        tmax=torch.where(valid, tmax, torch.full((), -1.0, device=dev)),
        time=torch.zeros((R,), device=dev) if time is None else time,
    )
    # shadow beams (clustered origins, light-convergent directions)
    # traverse with the frustum cull
    return scene.intersect_p(ray, coherent=True)


def estimate_direct(scene, lobes: Lobes, frame: Frame, p, wo, u_light, u1, u2,
                    active, time=None):
    """One-light direct illumination, light-sampling half of the MIS
    pair (the BSDF half is the next vertex's emission). Returns [N, S]."""
    if scene.lights is None:
        return torch.zeros(p.shape[:-1] + (S,), device=p.device)
    light_idx, pick_pmf = scene.light_dist.sample_discrete(u_light)
    ls = sample_light(scene.lights, light_idx, p, u1, u2)
    f = bsdf_f(lobes, frame, wo, ls.wi)
    cos_i = torch.abs(dot(ls.wi, frame.ns))
    usable = (active & (cos_i > 0) & (ls.pdf > 1e-9) & ~spec.is_black(ls.L)
              & ~spec.is_black(f))
    occluded = _occluded(scene, p, ls.wi, ls.dist, usable, time=time)
    usable = usable & ~occluded
    # MIS weight (light strategy): delta lights get weight 1
    bpdf = bsdf_pdf(lobes, frame, wo, ls.wi)
    w = torch.where(ls.is_delta, torch.ones((), device=p.device),
                    power_heuristic(1.0, ls.pdf * pick_pmf, 1.0, bpdf))
    contrib = f * ls.L * (cos_i * w / torch.clamp(ls.pdf * pick_pmf, min=1e-12))[..., None]
    return torch.where(usable[..., None], contrib, torch.zeros((), device=p.device))


class PathState(NamedTuple):
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    throughput: torch.Tensor     # [N, S]
    L: torch.Tensor              # [N, S]
    alive: torch.Tensor          # [N]
    prev_bsdf_pdf: torch.Tensor  # [N] pdf of the sample that produced this ray
    prev_specular: torch.Tensor  # [N] previous bounce was specular
    lam_nm: torch.Tensor         # [N] carried wavelength (<0: dense)


def _add_hit_emission(scene, st: PathState, hit: Hit, first: bool):
    """Emission picked up by the continuation/camera ray, MIS-weighted."""
    if scene.lights is None:
        return st.L
    dev = hit.t.device
    wo = -normalize(st.ray_d)
    light = torch.clamp(hit.light, min=0)
    le = area_emission(scene.lights, light, hit.ng, wo)
    emissive = hit.valid & (hit.light >= 0)
    if first:
        w = torch.ones(hit.t.shape, device=dev)
    else:
        # light pdf of having sampled this direction toward the area light
        d = hit.p - st.ray_o
        dist2 = torch.clamp(torch.sum(d * d, -1), min=1e-12)
        cos_l = dot(hit.ng, wo)
        lpdf = area_tri_pdf(scene.lights, light, dist2, cos_l)
        pick = scene.light_dist.pdf_discrete(light)
        w = torch.where(st.prev_specular, torch.ones((), device=dev),
                        power_heuristic(1.0, st.prev_bsdf_pdf, 1.0, lpdf * pick))
    add = st.throughput * le * w[..., None]
    return st.L + torch.where((emissive & st.alive)[..., None], add,
                              torch.zeros((), device=dev))


def li_path(scene, ray: Ray, pixel, sidx, max_depth: int = 5, seed: int = 0,
            rr_start: int = 3):
    """Path-traced radiance for a ray batch (reference integrators/
    path.cpp:52-123: MIS one-light, RR after bounce 3). Returns [N, S]."""

    def u_fn(depth, dim):
        return iu(pixel, sidx, depth, dim, seed)

    return _li_path_impl(scene, ray, u_fn, max_depth, rr_start)


def _li_path_impl(scene, ray: Ray, u_fn, max_depth: int, rr_start: int):
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    N = ray.o.shape[0]
    dev = ray.o.device
    zero = torch.zeros((), device=dev)
    st = PathState(
        ray_o=ray.o, ray_d=ray.d,
        throughput=torch.ones((N, S), device=dev),
        L=torch.zeros((N, S), device=dev),
        alive=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_bsdf_pdf=torch.zeros((N,), device=dev),
        prev_specular=torch.zeros((N,), dtype=torch.bool, device=dev),
        lam_nm=torch.full((N,), -1.0, device=dev),
    )
    tm = ray.time  # shutter time, constant along the path
    # per-material dispersive flag with a trailing 0 (hit.mat = -1 clips to 0
    # as in the reference)
    disp = torch.cat([scene.material_dispersive.to(torch.int32),
                      torch.zeros((1,), dtype=torch.int32, device=dev)])

    for depth in range(max_depth + 1):
        # dead lanes get an empty [0, -1] interval: the accelerators skip
        # them (the packet pipeline sorts them into all-dead tiles)
        hit = scene.intersect(Ray(st.ray_o, st.ray_d, torch.zeros((N,), device=dev),
                                  torch.where(st.alive, torch.full((), BIG, device=dev),
                                              torch.full((), -1.0, device=dev)), tm),
                              coherent=depth == 0)
        st = st._replace(L=_add_hit_emission(scene, st, hit, depth == 0))
        alive = st.alive & hit.valid
        if depth == max_depth:
            break

        lobes = material_lobes(eval_bsdf_params(scene, hit))
        frame = make_frame(hit)
        wo = -normalize(st.ray_d)

        # direct lighting at non-specular vertices
        Ld = estimate_direct(scene, lobes, frame, hit.p, wo, u_fn(depth, 0),
                             u_fn(depth, 1), u_fn(depth, 2),
                             alive & has_non_specular(lobes), time=tm)
        # carried-wavelength band filter on new light (monochromatic lanes)
        mono = st.lam_nm > 0.0
        Ld = torch.where(mono[..., None], spec.band_filter(Ld, st.lam_nm), Ld)
        st = st._replace(L=st.L + st.throughput * Ld * alive[..., None])

        # continuation: BSDF sample (with dispersion wavelength pick)
        is_disp = disp[torch.clamp(hit.mat, 0, disp.shape[0] - 1)] > 0
        # the candidate wavelength is committed only when the sampled
        # lobe is specular transmission (reflection does not disperse)
        need_lambda = is_disp & (st.lam_nm < 0.0) & alive
        bin_idx, bin_w = spec.sample_bin(st.throughput, u_fn(depth, 3))
        new_lam = spec.bin_wavelength(bin_idx)
        oh = spec.one_hot(bin_idx)
        lam_cand = torch.where(need_lambda, new_lam, st.lam_nm)

        bs = bsdf_sample(lobes, frame, wo, u_fn(depth, 4), u_fn(depth, 5),
                         u_fn(depth, 6), lam_nm=lam_cand)
        commit_lambda = need_lambda & bs.did_transmit
        tp = torch.where(commit_lambda[..., None], st.throughput * oh * bin_w[..., None],
                         st.throughput)
        lam = torch.where(commit_lambda, new_lam, st.lam_nm)
        cos_i = torch.abs(dot(bs.wi, frame.ns))
        tp_new = tp * bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[..., None]
        alive = alive & bs.valid & ~spec.is_black(tp_new)

        # Russian roulette (reference path.cpp: after bounce 3)
        if depth >= rr_start:
            q = torch.clamp(spec.y(tp_new) / torch.clamp(spec.y(tp), min=1e-9), 0.05, 1.0)
            survive = u_fn(depth, 8) < q
            tp_new = tp_new / torch.clamp(q, min=1e-9)[..., None]
            alive = alive & survive

        st = PathState(
            ray_o=hit.p + bs.wi * RAY_EPS,
            ray_d=bs.wi,
            throughput=torch.where(alive[..., None], tp_new, zero),
            L=st.L,
            alive=alive,
            prev_bsdf_pdf=bs.pdf,
            prev_specular=bs.is_specular,
            lam_nm=lam,
        )
    return st.L
