"""The remaining surface integrators: igi, irradiancecache, dipole
subsurface, and the SH / PRT trio (diffuseprt, glossyprt, useprobes).

Port of pbrt_tpu/integrators/extra.py, with its redesigns of the
reference's serial algorithms:

- igi (reference integrators/igi.cpp): VPL sets come from one batch of
  light paths (generate_vpls); Li adds direct light and the VPLs of one
  set per pixel, picked by a hash of the pixel, with the gLimit clamp.
- irradiancecache (reference integrators/irradiancecache.cpp): no
  octree cache; each hit gathers irradiance from n cosine rays, each
  shaded by direct light at the gather hit.
- dipolesubsurface (reference integrators/dipolesubsurface.cpp): the
  irradiance at surface points (renderers/surfacepoints.py) in one
  pass (compute_point_irradiance); Li sums the dipole diffusion Rd over
  all points. The JAX package forms [N, P, S] in one piece; this one
  sums over P in chunks sized to fit free memory, so the sum's order
  differs (float32 rounding only).
- diffuseprt / glossyprt (reference diffuseprt.cpp, glossyprt.cpp): a
  per-hit projection of visibility x cosine onto SH, dotted with the
  lights' SH projection (_light_sh); glossyprt uses a zonal lobe around
  the reflection direction.
- useprobes (reference useprobes.cpp): trilinear interpolation of a
  probe grid's SH coefficients (renderers/createprobes.py), convolved
  with the cosine lobe at the shading normal.

Every ray these functions trace goes through scene.intersect /
intersect_p, so through K1 or K2 on the card.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import sh as shm
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import Ray, dot, normalize
from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere, mul32
from pbrt_tpu_torch.integrators.surface import (
    BIG,
    RAY_EPS,
    PathState,
    _add_hit_emission,
    _occluded,
    estimate_direct,
    make_frame,
)
from pbrt_tpu_torch.lights.lighting import L_DISTANT, env_le, sample_light, sample_light_ray
from pbrt_tpu_torch.materials.bsdf import bsdf_f, bsdf_sample, fresnel_dielectric, material_lobes
from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu

S = spec.N_BINS
INV_PI = 1.0 / math.pi


def _camera_hit(scene, ray: Ray):
    """The camera rays' hit, the emission they see there, and the hit's
    lobes and shading frame (no bump: the JAX package's make_frame)."""
    N = ray.o.shape[0]
    dev = ray.o.device
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    hit = scene.intersect(ray, coherent=True)
    st = PathState(ray.o, ray.d, torch.ones((N, S), device=dev), torch.zeros((N, S), device=dev),
                   torch.ones((N,), dtype=torch.bool, device=dev), torch.zeros((N,), device=dev),
                   torch.ones((N,), dtype=torch.bool, device=dev),
                   torch.full((N,), -1.0, device=dev))
    L = _add_hit_emission(scene, st, hit, True)
    return hit, L, material_lobes(eval_bsdf_params(scene, hit)), make_frame(hit)


def _direct(scene, hit, L, lobes, frame, wo, pixel, sidx, seed, transmittance_fn):
    """L + one light sample's direct light at the camera hit."""
    return L + estimate_direct(scene, lobes, frame, hit.p, wo, iu(pixel, sidx, 0, 0, seed),
                               iu(pixel, sidx, 0, 1, seed), iu(pixel, sidx, 0, 2, seed),
                               hit.valid, transmittance_fn)


# ---------------------------------------------------------------------------
# igi

class VplSets(NamedTuple):
    p: torch.Tensor       # [sets, n, 3]
    n: torch.Tensor       # [sets, n, 3]
    le: torch.Tensor      # [sets, n, S] path contribution
    valid: torch.Tensor   # [sets, n] bool


def generate_vpls(scene, n_sets: int, n_per_set: int, max_depth: int,
                  seed: int) -> Optional[VplSets]:
    """Light-path precompute (reference igi.cpp Preprocess): n_sets x
    n_per_set light paths of up to max_depth vertices; each vertex is a
    VPL carrying the path's throughput times its diffuse reflectance."""
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    if scene.lights is None:
        return None
    dev = scene.geom.tri_v0.device
    total = n_sets * n_per_set
    lane = torch.arange(total, dtype=torch.int64, device=dev)
    zl = torch.zeros_like(lane)
    world_c = torch.as_tensor((0.5 * (scene.world_lo + scene.world_hi)).astype(np.float32),
                              device=dev)
    world_rad = float(np.linalg.norm(scene.world_hi - scene.world_lo) * 0.5) + 1e-3

    def u(d, i):
        return iu(lane, zl, d, i, seed + 77)

    li, pmf = scene.light_dist.sample_discrete(u(0, 0))
    lr = sample_light_ray(scene.lights, li, world_c, world_rad, u(0, 1), u(0, 2), u(0, 3),
                          u(0, 4))
    alpha = lr.alpha / torch.clamp(pmf, min=1e-12)[..., None]
    ray_o, ray_d = lr.o, lr.d
    alive = ~spec.is_black(alpha)
    zf = torch.zeros((total,), device=dev)
    zero = torch.zeros((), device=dev)
    ps, ns, les, vs = [], [], [], []
    for depth in range(max_depth):
        # every lane is traced, as in the JAX package (dead lanes' VPLs
        # keep the positions of their hits, with valid False)
        hit = scene.intersect(Ray(ray_o, ray_d, zf, torch.full((total,), BIG, device=dev), zf))
        ok = alive & hit.valid
        lobes = material_lobes(eval_bsdf_params(scene, hit))
        ps.append(hit.p)
        ns.append(hit.ns)
        les.append(torch.where(ok[..., None], alpha * lobes.diff_r * INV_PI, zero))
        vs.append(ok)
        if depth == max_depth - 1:
            break
        frame = make_frame(hit)
        wo = -normalize(ray_d)
        bs = bsdf_sample(lobes, frame, wo, u(depth, 5), u(depth, 6), u(depth, 7), u(depth, 8))
        cos_i = torch.abs(dot(bs.wi, frame.ns))
        anew = alpha * bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[..., None]
        cont = torch.clamp(spec.y(anew) / torch.clamp(spec.y(alpha), min=1e-12), 0.05, 1.0)
        alive = ok & bs.valid & (u(depth, 9) < cont) & ~spec.is_black(anew)
        alpha = anew / torch.clamp(cont, min=1e-9)[..., None]
        ray_o = hit.p + bs.wi * RAY_EPS
        ray_d = bs.wi
    D = len(ps)
    return VplSets(p=torch.stack(ps, 1).reshape(n_sets, n_per_set * D, 3),
                   n=torch.stack(ns, 1).reshape(n_sets, n_per_set * D, 3),
                   le=torch.stack(les, 1).reshape(n_sets, n_per_set * D, S),
                   valid=torch.stack(vs, 1).reshape(n_sets, n_per_set * D))


def igi_set_index(pixel, n_sets: int):
    """The VPL set of each pixel: (pixel * 2654435761 mod 2^32) >> 8,
    mod n_sets (uint32 arithmetic, as the JAX package wraps it)."""
    return (mul32(pixel, 2654435761) >> 8) % n_sets


def li_igi(scene, vpls: Optional[VplSets], ray: Ray, pixel, sidx, max_depth: int = 5,
           g_limit: float = 10.0, seed: int = 0, transmittance_fn=None):
    """Direct light + one VPL set's gather (reference igi.cpp:140-230)."""
    hit, L, lobes, frame = _camera_hit(scene, ray)
    wo = -normalize(ray.d)
    L = _direct(scene, hit, L, lobes, frame, wo, pixel, sidx, seed, transmittance_fn)
    if vpls is None:
        return L
    set_idx = igi_set_index(pixel, vpls.p.shape[0])
    vp, vn, vle, vvalid = (x[set_idx] for x in vpls)
    d = vp - hit.p[:, None, :]
    d2 = torch.clamp(torch.sum(d * d, -1), min=1e-8)
    wi = d / torch.sqrt(d2)[..., None]
    cos_s = torch.clamp(dot(wi, hit.ns[:, None, :]), min=0.0)
    cos_l = torch.clamp(dot(-wi, vn), min=0.0)
    G = torch.clamp(cos_s * cos_l / d2, max=g_limit)   # the gLimit clamp (reference :200)
    zero = torch.zeros((), device=L.device)
    contrib = torch.zeros_like(L)
    for vi in range(vp.shape[1]):   # one shadow ray per VPL
        use = hit.valid & vvalid[:, vi] & (G[:, vi] > 1e-9)
        occ = _occluded(scene, hit.p, wi[:, vi], torch.sqrt(d2[:, vi]), use)
        c = bsdf_f(lobes, frame, wo, wi[:, vi]) * vle[:, vi] * G[:, vi][..., None]
        contrib = contrib + torch.where((use & ~occ)[..., None], c, zero)
    return L + contrib


# ---------------------------------------------------------------------------
# irradiancecache (cache-free hemisphere gathering)

def li_irradiance(scene, ray: Ray, pixel, sidx, n_samples: int = 8, seed: int = 0,
                  transmittance_fn=None):
    """Direct light + rho/pi x the irradiance of n_samples cosine gather
    rays, each shaded by direct light at its hit only: the reference's
    pathL adds no emission at a gather vertex, so a gather ray that
    strikes an area light adds nothing."""
    N = ray.o.shape[0]
    dev = ray.o.device
    hit, L, lobes, frame = _camera_hit(scene, ray)
    wo = -normalize(ray.d)
    L = _direct(scene, hit, L, lobes, frame, wo, pixel, sidx, seed, transmittance_fn)
    # lanes without a camera hit gather nothing (their terms are masked
    # by hit.valid), so they get an empty interval and are not traced
    g_tmax = torch.where(hit.valid, torch.full((), BIG, device=dev),
                         torch.full((), -1.0, device=dev))
    flip = (dot(wo, frame.ns) < 0)[..., None]
    E = torch.zeros((N, S), device=dev)
    for g in range(n_samples):
        E = E + irradiance_gather(scene, hit, frame, flip, g_tmax, pixel, sidx, g, seed,
                                  transmittance_fn)
    E = E * (math.pi / n_samples)   # the cosine pdf cancels the cosine
    return L + lobes.diff_r * INV_PI * E


def irradiance_gather(scene, hit, frame, flip, g_tmax, pixel, sidx, g: int, seed: int,
                      transmittance_fn):
    """Gather ray g of li_irradiance: a cosine direction about the
    shading normal (flipped to wo's side), traced, and direct light at
    its hit -> [N, S] (0 where it hits nothing)."""
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    dev = hit.p.device
    zf = torch.zeros_like(g_tmax)
    wl = cosine_sample_hemisphere(iu(pixel, sidx, g, 20, seed), iu(pixel, sidx, g, 21, seed))
    wl = torch.where(flip, wl * torch.tensor([1.0, 1.0, -1.0], device=dev), wl)
    wi = frame.to_world(wl)
    ghit = scene.intersect(Ray(hit.p + wi * RAY_EPS, wi, zf, g_tmax, zf))
    Lg = estimate_direct(scene, material_lobes(eval_bsdf_params(scene, ghit)), make_frame(ghit),
                         ghit.p, -wi, iu(pixel, sidx, g, 22, seed), iu(pixel, sidx, g, 23, seed),
                         iu(pixel, sidx, g, 24, seed), ghit.valid & hit.valid, transmittance_fn)
    return torch.where(ghit.valid[..., None], Lg, torch.zeros((), device=dev))


# ---------------------------------------------------------------------------
# dipole subsurface

class SurfacePoints(NamedTuple):
    p: torch.Tensor      # [P, 3]
    n: torch.Tensor      # [P, 3]
    area: torch.Tensor   # [P]
    E: torch.Tensor      # [P, S] irradiance (compute_point_irradiance)


def dipole_rd(d2, sigma_a, sigma_ps, eta: float = 1.3):
    """Classical dipole diffusion Rd(r) (reference dipolesubsurface.cpp;
    Jensen 2001): d2 [...] squared distances, sigma [S] -> [..., S]."""
    sigma_t = sigma_a + sigma_ps
    alpha_p = sigma_ps / torch.clamp(sigma_t, min=1e-9)
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigma_t)
    Fdr = -1.440 / (eta * eta) + 0.710 / eta + 0.668 + 0.0636 * eta
    A = (1.0 + Fdr) / (1.0 - Fdr)
    zr = 1.0 / torch.clamp(sigma_t, min=1e-9)
    zv = zr * (1.0 + 4.0 / 3.0 * A)
    dr = torch.sqrt(d2[..., None] + zr * zr)
    dv = torch.sqrt(d2[..., None] + zv * zv)
    c1 = zr * (sigma_tr + 1.0 / dr)
    c2 = zv * (sigma_tr + 1.0 / dv)
    rd = alpha_p / (4.0 * math.pi) * (c1 * torch.exp(-sigma_tr * dr) / (dr * dr)
                                      + c2 * torch.exp(-sigma_tr * dv) / (dv * dv))
    return torch.clamp(rd, min=0.0)


# elements of one [N, P_chunk, S] block of the dipole sum (its
# temporaries hold about 10 of them)
DIPOLE_CHUNK_ELEMS = 1 << 25


def dipole_chunk(N: int, P: int) -> int:
    """Points per chunk of the dipole sum at N shading points: a block
    of DIPOLE_CHUNK_ELEMS elements."""
    return int(max(1, min(P, DIPOLE_CHUNK_ELEMS // max(N * S, 1))))


def li_dipole(scene, pts: Optional[SurfacePoints], ray: Ray, pixel, sidx, sigma_a, sigma_ps,
              eta: float = 1.3, scale: float = 1.0, seed: int = 0, transmittance_fn=None):
    """Eye pass: Sd = (1/pi) Ft sum_p Rd(|x - p|) E_p A_p (reference
    dipolesubsurface.cpp:221-287), summed over the points in chunks."""
    hit, L, lobes, frame = _camera_hit(scene, ray)
    dev = L.device
    wo = -normalize(ray.d)
    L = _direct(scene, hit, L, lobes, frame, wo, pixel, sidx, seed, transmittance_fn)
    if pts is None:
        return L
    sa = torch.as_tensor(np.asarray(sigma_a), dtype=torch.float32, device=dev) * scale
    sps = torch.as_tensor(np.asarray(sigma_ps), dtype=torch.float32, device=dev) * scale
    ea = pts.E * pts.area[:, None]
    N, P = hit.p.shape[0], pts.p.shape[0]
    step = dipole_chunk(N, P)
    mo = torch.zeros((N, S), device=dev)
    for p0 in range(0, P, step):
        d2 = torch.sum((pts.p[None, p0:p0 + step] - hit.p[:, None]) ** 2, -1)   # [N, Pc]
        mo = mo + torch.einsum("nps,ps->ns", dipole_rd(d2, sa, sps, eta), ea[p0:p0 + step])
    ft = 1.0 - fresnel_dielectric(dot(wo, frame.ns), 1.0, eta)
    return L + (INV_PI * ft)[..., None] * mo


def compute_point_irradiance(scene, pts: SurfacePoints, seed: int = 0) -> SurfacePoints:
    """Irradiance at each surface point from direct light, 4 light
    samples each (reference dipolesubsurface.cpp Preprocess)."""
    P = pts.p.shape[0]
    dev = pts.p.device
    lane = torch.arange(P, dtype=torch.int64, device=dev)
    zl = torch.zeros_like(lane)
    zero = torch.zeros((), device=dev)
    E = torch.zeros((P, S), device=dev)
    n_s = 4
    if scene.lights is not None:
        for g in range(n_s):
            li, pmf = scene.light_dist.sample_discrete(iu(lane, zl, g, 80, seed))
            ls = sample_light(scene.lights, li, pts.p, iu(lane, zl, g, 81, seed),
                              iu(lane, zl, g, 82, seed))
            cos_i = torch.clamp(dot(ls.wi, pts.n), min=0.0)
            ok = (ls.pdf > 1e-9) & (cos_i > 0)
            occ = _occluded(scene, pts.p, ls.wi, ls.dist, ok)
            E = E + torch.where((ok & ~occ)[..., None],
                                ls.L * (cos_i / torch.clamp(ls.pdf * pmf, min=1e-12))[..., None],
                                zero)
    return pts._replace(E=E / n_s)


# ---------------------------------------------------------------------------
# PRT trio

def li_diffuseprt(scene, ray: Ray, pixel, sidx, lmax: int = 4, n_samples: int = 8,
                  seed: int = 0):
    """Transfer T = int V(w) max(0, n.w) Y(w) dw by cosine-sampled rays;
    L = rho/pi <T, c_light> (reference integrators/diffuseprt.cpp:100)."""
    hit, _, lobes, frame = _camera_hit(scene, ray)
    N = ray.o.shape[0]
    dev = ray.o.device
    c_light = _light_sh(scene, lmax)   # [T, S]
    trans = torch.zeros((N, shm.sh_terms(lmax)), device=dev)
    big = torch.full((N,), BIG, device=dev)
    for g in range(n_samples):
        w = frame.to_world(cosine_sample_hemisphere(iu(pixel, sidx, g, 30, seed),
                                                    iu(pixel, sidx, g, 31, seed)))
        occ = _occluded(scene, hit.p, w, big, hit.valid)
        weight = (hit.valid & ~occ).to(torch.float32) * (math.pi / n_samples)
        trans = trans + shm.sh_evaluate(w, lmax) * weight[..., None]
    L = torch.einsum("nt,ts->ns", trans, c_light) * lobes.diff_r * INV_PI
    return torch.where(hit.valid[..., None], torch.clamp(L, min=0.0),
                       torch.zeros((), device=dev))


def li_glossyprt(scene, ray: Ray, pixel, sidx, lmax: int = 4, n_samples: int = 8,
                 roughness: float = 0.1, seed: int = 0):
    """Glossy PRT with the Torrance lobe taken as its zonal expansion
    around the reflection vector: L = sum_l lam_l <c_light, Y(refl)>,
    with visibility along the reflection direction (the reference
    carries SH rotation and BRDF matrices, glossyprt.cpp:140)."""
    hit, _, lobes, _ = _camera_hit(scene, ray)
    N = ray.o.shape[0]
    dev = ray.o.device
    wo = -normalize(ray.d)
    refl = normalize(2.0 * dot(wo, hit.ns)[..., None] * hit.ns - wo)
    c_light = _light_sh(scene, lmax)
    e = 1.0 / max(roughness, 1e-3)   # lobe exponent -> lam_l = exp(-l^2 / 2e)
    lam = np.zeros(shm.sh_terms(lmax))
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            lam[shm.sh_index(l, m)] = np.exp(-l * l / (2.0 * e))
    lam_t = torch.as_tensor(lam.astype(np.float32), device=dev)
    L = torch.einsum("nt,ts->ns", shm.sh_evaluate(refl, lmax) * lam_t, c_light) * lobes.gloss
    occ = _occluded(scene, hit.p, refl, torch.full((N,), BIG, device=dev), hit.valid)
    return torch.where((hit.valid & ~occ)[..., None], torch.clamp(L, min=0.0),
                       torch.zeros((), device=dev))


def _light_sh(scene, lmax: int):
    """SH projection [T, S] of the scene's distant illumination (env
    maps and distant lights, the latter as narrow normalized lobes),
    cached on the compiled scene. The JAX package caches by id(scene),
    which a later scene can reuse once the first is freed (ROADMAP R20);
    where its cache is right, the result is the same."""
    cache = scene.light_sh
    if lmax in cache:
        return cache[lmax]
    dev = scene.geom.tri_v0.device
    dirs, w = shm.sphere_quadrature(24, 48, device=dev)
    if scene.lights is not None and scene.lights.envs:
        vals = env_le(scene.lights, dirs)
    else:
        vals = torch.zeros((dirs.shape[0], S), device=dev)
    if scene.lights is not None:
        kinds = scene.lights.kind.cpu().numpy()
        for li in np.nonzero(kinds == L_DISTANT)[0]:
            wi = scene.lights.params[li, 0:3]
            conc = torch.exp(80.0 * (dot(dirs, normalize(wi[None])) - 1.0))
            norm = torch.sum(conc * w)
            vals = vals + (conc / torch.clamp(norm, min=1e-9))[:, None] * scene.lights.spectra[li]
    cache[lmax] = shm.project_function(vals, dirs, w, lmax)
    return cache[lmax]


class ProbeGrid(NamedTuple):
    """SH radiance probes on a regular grid (createprobes output)."""

    lo: torch.Tensor        # [3]
    hi: torch.Tensor        # [3]
    dims: tuple             # (nx, ny, nz)
    coeffs: torch.Tensor    # [nz, ny, nx, T, S]
    lmax: int


def li_useprobes(scene, probes: Optional[ProbeGrid], ray: Ray, pixel, sidx, seed: int = 0):
    """Trilinear probe interpolation dotted with the cosine-convolved
    basis at the shading normal (reference useprobes.cpp:54)."""
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    N = ray.o.shape[0]
    dev = ray.o.device
    hit = scene.intersect(ray, coherent=True)
    if probes is None:
        return torch.zeros((N, S), device=dev)
    lobes = material_lobes(eval_bsdf_params(scene, hit))
    nx, ny, nz = probes.dims
    t = (hit.p - probes.lo) / torch.clamp(probes.hi - probes.lo, min=1e-9)
    g = t * torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.float32, device=dev)
    g0 = torch.minimum(torch.clamp(torch.floor(g).to(torch.int64), min=0),
                       torch.tensor([max(nx - 2, 0), max(ny - 2, 0), max(nz - 2, 0)], device=dev))
    f = g - g0
    c = torch.zeros((N, probes.coeffs.shape[3], S), device=dev)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                xi = torch.clamp(g0[:, 0] + dx, max=nx - 1)
                yi = torch.clamp(g0[:, 1] + dy, max=ny - 1)
                zi = torch.clamp(g0[:, 2] + dz, max=nz - 1)
                wgt = ((f[:, 0] if dx else 1 - f[:, 0]) * (f[:, 1] if dy else 1 - f[:, 1])
                       * (f[:, 2] if dz else 1 - f[:, 2]))
                c = c + probes.coeffs[zi, yi, xi] * wgt[:, None, None]
    lam = torch.as_tensor(shm.lambda_l(probes.lmax).astype(np.float32), device=dev)
    E = torch.einsum("nt,nts->ns", shm.sh_evaluate(hit.ns, probes.lmax) * lam[None], c)
    L = lobes.diff_r * INV_PI * torch.clamp(E, min=0.0)
    return torch.where(hit.valid[..., None], L, torch.zeros((), device=dev))
