"""Photon-mapping surface integrator.

Port of pbrt_tpu/integrators/photonmap.py (reference integrators/
photonmap.cpp): direct lighting + the caustic photon density estimate +
the indirect estimate (final-gathered or read from the map) + specular
recursion. The density kernel is the reference's Simpson kernel
k(d) = 3/pi (1 - d2/r2)^2 / r2.

Lanes the estimates cannot reach are left out of the lookups and gather
traversals (photon/map.py's `mask`, an empty ray interval), and the depth
loop and the final gather stop when no lane is left (one host sync
each): the JAX package computes those results and masks them, so the
radiance is the same.
"""
from __future__ import annotations

import math

import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import Ray, coordinate_system, dot, normalize
from pbrt_tpu_torch.core.sampling import power_heuristic, uniform_sample_cone
from pbrt_tpu_torch.integrators.surface import (
    BIG,
    RAY_EPS,
    PathState,
    _add_hit_emission,
    estimate_direct,
    make_frame,
)
from pbrt_tpu_torch.materials.bsdf import (
    bsdf_f,
    bsdf_pdf,
    bsdf_sample,
    has_non_specular,
    material_lobes,
    rho_proxies,
)
from pbrt_tpu_torch.photon import map as pmap
from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu

S = spec.N_BINS
INV_PI = 1.0 / math.pi
N_IND = 50   # indirect photons whose directions steer the cone gather (reference :193-207)


def _simpson_kernel(d2, r2):
    s = torch.clamp(1.0 - d2 / torch.clamp(r2, min=1e-12), min=0.0)
    return 3.0 * INV_PI * s * s / torch.clamp(r2, min=1e-12)


def lphoton_surface(pm, lobes, frame, p, wo, n_used: int, max_dist2: float, mask=None):
    """Surface radiance estimate from a photon map (reference
    photonmap.cpp LPhoton): Simpson-kernel flux split by hemisphere
    against Nf = Faceforward(ns, wo); reflected flux x rho_r / pi plus
    transmitted flux x rho_t / pi (:88-103). [N, S]. A call that reads
    a map is one `photon/lookup` span while tracing is on, and adds its
    live queries to the counter `photon/lookup_queries`."""
    if pm is None:
        return torch.zeros(p.shape[:-1] + (S,), device=p.device)
    with probes.scope("photon/lookup"):
        sgn = torch.where(dot(wo, frame.ns) >= 0.0, 1.0, -1.0)   # Nf orientation

        def weight(wix, wiy, wiz, d2, valid, r2, ns, sg):
            kern = _simpson_kernel(d2, r2[:, None])
            cosn = (wix * ns[:, 0:1] + wiy * ns[:, 1:2] + wiz * ns[:, 2:3]) * sg[:, None]
            front = cosn > 0.0
            zero = torch.zeros((), device=kern.device)
            return torch.stack([torch.where(front, kern, zero), torch.where(front, zero, kern)],
                               -1)

        res = pmap.knn_weighted_flux(pm, p, n_used, max_dist2, weight, extras=(frame.ns, sgn),
                                     mask=mask, n_channels=2)
        probes.count("photon/lookup_queries", int(res.n_live))
        rho_r, rho_t = rho_proxies(lobes)
        return (res.flux[:, 0] * rho_r + res.flux[:, 1] * rho_t) * INV_PI


def li_photonmap(scene, ctx, ray: Ray, pixel, sidx, max_depth: int = 5, seed: int = 0,
                 transmittance_fn=None):
    """Eye-side evaluation: direct + caustic + indirect + specular
    recursion (reference photonmap.cpp:159-331). Returns [N, S]."""
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    N = ray.o.shape[0]
    dev = ray.o.device
    zero = torch.zeros((), device=dev)
    st = PathState(ray_o=ray.o, ray_d=ray.d, throughput=torch.ones((N, S), device=dev),
                   L=torch.zeros((N, S), device=dev),
                   alive=torch.ones((N,), dtype=torch.bool, device=dev),
                   prev_bsdf_pdf=torch.zeros((N,), device=dev),
                   prev_specular=torch.ones((N,), dtype=torch.bool, device=dev),
                   lam_nm=torch.full((N,), -1.0, device=dev))
    tm = ray.time
    for depth in range(max_depth + 1):
        hit = scene.intersect(Ray(st.ray_o, st.ray_d, torch.zeros((N,), device=dev),
                                  torch.where(st.alive, torch.full((), BIG, device=dev),
                                              torch.full((), -1.0, device=dev)), tm),
                              coherent=depth == 0)
        st = st._replace(L=_add_hit_emission(scene, st, hit, depth == 0))
        alive = st.alive & hit.valid
        if depth == max_depth or not bool(alive.any()):
            break
        lobes = material_lobes(eval_bsdf_params(scene, hit))
        frame = make_frame(hit)
        wo = -normalize(st.ray_d)
        shade = alive & has_non_specular(lobes)

        Ld = estimate_direct(scene, lobes, frame, hit.p, wo, iu(pixel, sidx, depth, 0, seed),
                             iu(pixel, sidx, depth, 1, seed), iu(pixel, sidx, depth, 2, seed),
                             shade, transmittance_fn=transmittance_fn, time=tm)
        Lc = lphoton_surface(ctx.caustic, lobes, frame, hit.p, wo, ctx.n_used, ctx.max_dist2,
                             mask=shade)
        if ctx.final_gather and ctx.indirect is not None and ctx.radiance is not None:
            Li_ind = _final_gather(scene, ctx, lobes, frame, hit.p, wo, pixel, sidx, depth,
                                   seed, shade)
        else:
            Li_ind = lphoton_surface(ctx.indirect, lobes, frame, hit.p, wo, ctx.n_used,
                                     ctx.max_dist2, mask=shade)
        add = (Ld + Lc + Li_ind) * st.throughput
        st = st._replace(L=st.L + torch.where(shade[..., None], add,
                                              torch.where(alive[..., None], Ld * st.throughput,
                                                          zero)))

        # specular-only recursion (SpecularReflect / SpecularTransmit)
        bs = bsdf_sample(lobes, frame, wo, iu(pixel, sidx, depth, 4, seed),
                         iu(pixel, sidx, depth, 5, seed), iu(pixel, sidx, depth, 6, seed),
                         iu(pixel, sidx, depth, 7, seed), lam_nm=st.lam_nm,
                         u_pick=iu(pixel, sidx, depth, 8, seed))
        cos_i = torch.abs(dot(bs.wi, frame.ns))
        tp_new = st.throughput * bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[..., None]
        alive = alive & bs.valid & bs.is_specular & ~spec.is_black(tp_new)
        st = PathState(ray_o=hit.p + bs.wi * RAY_EPS, ray_d=bs.wi,
                       throughput=torch.where(alive[..., None], tp_new, zero), L=st.L,
                       alive=alive, prev_bsdf_pdf=bs.pdf,
                       prev_specular=torch.ones((N,), dtype=torch.bool, device=dev),
                       lam_nm=st.lam_nm)
    return st.L


def _final_gather(scene, ctx, lobes, frame, p, wo, pixel, sidx, depth, seed, shade):
    """One-bounce final gather with the reference's two MIS-combined
    strategies (photonmap.cpp:183-296): BSDF-sampled and
    photon-cone-sampled gather rays, each shaded at its hit by the
    nearest radiance photon's precomputed Lo (photonshooter.cpp:506-523).
    Each strategy runs ctx.gather_samples rays (the reference's
    gatherSamples / 2 split), one Python loop iteration per sample.
    shade [N]: the lanes whose result is read."""
    N = p.shape[0]
    dev = p.device
    zero = torch.zeros((), device=dev)
    acc = torch.zeros((N, S), device=dev)
    if not bool(shade.any()):
        return acc
    n_g = max(1, ctx.gather_samples)
    cos_ga = ctx.cos_gather_angle
    cone_pdf = 1.0 / (2.0 * math.pi * max(1.0 - cos_ga, 1e-6))

    # nearby indirect photons' directions for importance sampling (the
    # reference doubles its radius until 50 are found; the grid uses a
    # generous fixed radius and tolerates fewer)
    pdx, pdy, pdz, pd_valid = pmap.knn_dirs(ctx.indirect, p, N_IND, ctx.max_dist2 * 16.0,
                                            mask=shade)
    n_pd = torch.clamp(torch.sum(pd_valid, -1), min=1)
    any_pd = torch.sum(pd_valid, -1) > 0

    def photon_pdf_of(wi):
        """pdf of photon-cone sampling producing wi (reference :229-235)."""
        cosw = pdx * wi[:, 0:1] + pdy * wi[:, 1:2] + pdz * wi[:, 2:3]
        cnt = torch.sum(((cosw > 0.999 * cos_ga) & pd_valid).to(torch.float32), -1)
        return cnt * cone_pdf / n_pd.to(torch.float32)

    zf = torch.zeros((N,), device=dev)

    def shade_gather_hit(wi, want):
        """Trace the gather rays of the lanes in `want`; Lo at each hit
        from the radiance map."""
        tmax = torch.where(want, torch.full((), BIG, device=dev), torch.full((), -1.0, device=dev))
        ghit = scene.intersect(Ray(p + wi * RAY_EPS, wi, zf, tmax, zf))
        n_gather = torch.where((dot(ghit.ns, -wi) < 0.0)[..., None], -ghit.ns, ghit.ns)
        lo, found = pmap.radiance_lookup(ctx.radiance, ghit.p, n_gather, mask=ghit.valid)
        return torch.where((ghit.valid & found)[..., None], lo, zero), ghit.valid

    for g in range(n_g):
        # strategy 1: BSDF sampling (reference :210-246); the reference
        # samples BSDF_ALL & ~BSDF_SPECULAR, so specular picks are dropped
        bs = bsdf_sample(lobes, frame, wo, iu(pixel, sidx, depth, 50 + 8 * g, seed),
                         iu(pixel, sidx, depth, 51 + 8 * g, seed),
                         iu(pixel, sidx, depth, 52 + 8 * g, seed),
                         iu(pixel, sidx, depth, 53 + 8 * g, seed),
                         u_pick=iu(pixel, sidx, depth, 57 + 8 * g, seed))
        ok1 = bs.valid & ~bs.is_specular & (bs.pdf > 1e-9) & ~spec.is_black(bs.f)
        Lind1, hit1 = shade_gather_hit(bs.wi, shade & ok1)
        wt1 = power_heuristic(n_g, bs.pdf, n_g, photon_pdf_of(bs.wi))
        c1 = bs.f * Lind1 * (torch.abs(dot(bs.wi, frame.ns)) * wt1
                             / torch.clamp(bs.pdf, min=1e-9))[..., None]
        acc = acc + torch.where((ok1 & hit1)[..., None], c1, zero)

        # strategy 2: photon-cone sampling (reference :249-293)
        u_c = iu(pixel, sidx, depth, 54 + 8 * g, seed)
        pick = torch.minimum((u_c * n_pd.to(torch.float32)).to(torch.int64), n_pd - 1)[:, None]
        axis = torch.stack([torch.gather(c, 1, pick)[:, 0] for c in (pdx, pdy, pdz)], -1)
        vx, vy = coordinate_system(axis)
        wl = uniform_sample_cone(iu(pixel, sidx, depth, 55 + 8 * g, seed),
                                 iu(pixel, sidx, depth, 56 + 8 * g, seed), cos_ga)
        wi2 = wl[..., 0:1] * vx + wl[..., 1:2] * vy + wl[..., 2:3] * axis
        fr2 = bsdf_f(lobes, frame, wo, wi2)
        ok2 = any_pd & ~spec.is_black(fr2)
        Lind2, hit2 = shade_gather_hit(wi2, shade & ok2)
        ppdf2 = photon_pdf_of(wi2)
        wt2 = power_heuristic(n_g, ppdf2, n_g, bsdf_pdf(lobes, frame, wo, wi2))
        c2 = fr2 * Lind2 * (torch.abs(dot(wi2, frame.ns)) * wt2
                            / torch.clamp(ppdf2, min=1e-9))[..., None]
        acc = acc + torch.where((ok2 & hit2 & (ppdf2 > 1e-9))[..., None], c2, zero)
    return acc / n_g
