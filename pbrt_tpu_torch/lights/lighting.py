"""Device-side light table + sampling over wavefront batches.

Port of pbrt_tpu/lights/lighting.py for point lights (reference
lights/point.cpp) and diffuse area lights (reference lights/diffuse.cpp)
on triangle meshes and quadrics. The table layout is the reference's
(kind + transforms + spectrum + params [L, 12]); area lights sample
their triangle soup (quadric emitters other than full spheres are
tessellated at compile time) by an area-weighted CDF per light segment,
and full-sphere emitters sample the subtended cone analytically
(reference shapes/sphere.cpp Sample):

  AREA params: [0]=total area [1]=is_sphere [2:5]=center [5]=radius
               [6]=tri_start [7]=tri_count

The other light kinds are not yet ported.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pbrt_tpu_torch.core.geometry import coordinate_system, cross, dot, length
from pbrt_tpu_torch.core.sampling import (
    uniform_cone_pdf,
    uniform_sample_cone,
    uniform_sample_sphere,
    uniform_sample_triangle,
)

# kind ids as in pbrt_tpu (L_POINT, L_SPOT, L_GONIO, L_PROJECTION,
# L_DISTANT, L_INFINITE, L_AREA = range(7))
L_POINT, L_AREA = 0, 6

BIG = 1e30


class LightsT(NamedTuple):
    kind: torch.Tensor       # [L] int32
    l2w: torch.Tensor        # [L, 4, 4]
    w2l: torch.Tensor        # [L, 4, 4]
    spectra: torch.Tensor    # [L, S] intensity / radiance
    params: torch.Tensor     # [L, 12]
    power: torch.Tensor      # [L, S]
    n_samples: torch.Tensor  # [L] int32
    # area-light triangle soup (subset copy of scene triangles)
    al_v0: torch.Tensor      # [AT, 3]
    al_e1: torch.Tensor
    al_e2: torch.Tensor
    al_cdf: torch.Tensor     # [AT] per-light prefix CDF over triangle area


class LightSample(NamedTuple):
    L: torch.Tensor          # [H, S] incident radiance (before visibility)
    wi: torch.Tensor         # [H, 3]
    pdf: torch.Tensor        # [H] (solid angle; delta lights use 1)
    dist: torch.Tensor       # [H] distance to the light point
    is_delta: torch.Tensor   # [H] bool


def _pick_area_tri(lights: LightsT, tri_start, tri_count, x):
    """Per lane, the smallest j in [start, start + count) with
    al_cdf[j] >= x, else start: the reference's masked pass over all
    area triangles, as one sorted search. Segments are contiguous and
    each one's CDF is nondecreasing, so the int64 keys (segment start,
    bits of the CDF value; both >= 0, so their bits order as their
    values) ascend over the whole table."""
    AT = lights.al_v0.shape[0]
    dev = x.device
    counts = lights.params[:, 7].to(torch.int64)
    starts = torch.where(counts > 0, lights.params[:, 6].to(torch.int64), 0)
    seg_start = torch.zeros((AT,), dtype=torch.int64, device=dev)
    seg_start = seg_start.scatter_reduce(0, torch.clamp(starts, 0, AT - 1), starts, "amax")
    seg_start = torch.cummax(seg_start, 0).values

    def bits(f):
        return f.contiguous().view(torch.int32).to(torch.int64)

    keys = (seg_start << 32) | bits(lights.al_cdf)
    j = torch.searchsorted(keys, (tri_start << 32) | bits(x))
    # a light with no triangles (a sphere) may start at AT: any row will
    # do, its lanes take the cone sample
    return torch.clamp(torch.where(j < tri_start + tri_count, j, tri_start), max=AT - 1)


def sample_light(lights: LightsT, light_idx, p, u1, u2) -> LightSample:
    """Sample an incident direction from light light_idx [H] at points p.
    Visibility is the caller's job (shadow ray from p toward wi with
    tmax = dist)."""
    H = p.shape[0]
    dev = p.device
    zero = torch.zeros((), device=dev)
    light_idx = light_idx.long()
    kind = lights.kind[light_idx]
    l2w = lights.l2w[light_idx]
    spectra = lights.spectra[light_idx]
    params = lights.params[light_idx]

    # POINT
    light_pos = l2w[..., :3, 3]
    d_to_light = light_pos - p
    dist2 = torch.clamp(torch.sum(d_to_light * d_to_light, -1), min=1e-12)
    dist = torch.sqrt(dist2)
    wi_point = d_to_light / dist[..., None]
    L_pt = spectra / dist2[..., None]

    # AREA: sample the light's triangle segment by its area CDF
    tri_start = params[..., 6].to(torch.int64)
    tri_count = params[..., 7].to(torch.int64)
    AT = lights.al_v0.shape[0]
    if AT > 0:
        tri_j = _pick_area_tri(lights, tri_start, tri_count, u1 * 0.9999999)
        v0 = lights.al_v0[tri_j]
        e1 = lights.al_e1[tri_j]
        e2 = lights.al_e2[tri_j]
        # u1 was consumed by the CDF pick; remap it for the barycentrics
        b0, b1 = uniform_sample_triangle(
            u2, torch.clamp(torch.remainder(u1 * 4096.0, 1.0), 0.0, 1.0))
        p_l = v0 + b0[..., None] * e1 + b1[..., None] * e2
        ng_l = cross(e1, e2)
        area2 = length(ng_l)
        ng_l = ng_l / torch.clamp(area2, min=1e-12)[..., None]
        d_al = p_l - p
        dist2_a = torch.clamp(torch.sum(d_al * d_al, -1), min=1e-12)
        dist_a = torch.sqrt(dist2_a)
        wi_area = d_al / dist_a[..., None]
        cos_l = torch.abs(dot(ng_l, -wi_area))
        total_area = torch.clamp(params[..., 0], min=1e-12)
        pdf_area = dist2_a / torch.clamp(cos_l * total_area, min=1e-9)
        # one-sided emission from the side of the normal
        emits = dot(ng_l, -wi_area) > 0.0
        L_area_tri = torch.where(emits[..., None], spectra, zero)
    else:
        wi_area = torch.zeros((H, 3), device=dev)
        pdf_area = torch.zeros((H,), device=dev)
        dist_a = torch.full((H,), BIG, device=dev)
        L_area_tri = torch.zeros_like(spectra)

    # AREA sphere: cone sampling (reference sphere.cpp Sample(p, u1, u2))
    center = params[..., 2:5]
    radius = params[..., 5]
    dc = center - p
    dc2 = torch.clamp(torch.sum(dc * dc, -1), min=1e-12)
    sin2_max = radius * radius / dc2
    outside = sin2_max < 1.0
    cos_max = torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0))
    wz = dc / torch.sqrt(dc2)[..., None]
    wx, wy = coordinate_system(wz)
    cone = uniform_sample_cone(u1, u2, cos_max)
    wi_sph = cone[..., 0:1] * wx + cone[..., 1:2] * wy + cone[..., 2:3] * wz
    pdf_sph = uniform_cone_pdf(cos_max)
    # inside the sphere: uniform area sampling
    sph_dir = uniform_sample_sphere(u1, u2)
    p_on = center + radius[..., None] * sph_dir
    d_in = p_on - p
    dist_in = torch.clamp(length(d_in), min=1e-9)
    wi_in = d_in / dist_in[..., None]
    cos_in = torch.abs(dot(sph_dir, -wi_in))
    area_sph = 4.0 * math.pi * radius * radius
    pdf_in = dist_in * dist_in / torch.clamp(cos_in * area_sph, min=1e-9)
    wi_sphere = torch.where(outside[..., None], wi_sph, wi_in)
    pdf_sphere = torch.where(outside, pdf_sph, pdf_in)
    # distance to the sphere's surface along wi (for the shadow ray)
    b_q = dot(wi_sphere, -dc)
    c_q = dc2 - radius * radius
    disc = b_q * b_q - c_q
    t_sph = -b_q - torch.sqrt(torch.clamp(disc, min=0.0))
    t_sph = torch.where(disc > 0, torch.clamp(t_sph, min=1e-4), torch.sqrt(dc2))

    is_sphere = params[..., 1] > 0.5
    wi_area = torch.where(is_sphere[..., None], wi_sphere, wi_area)
    pdf_area = torch.where(is_sphere, pdf_sphere, pdf_area)
    dist_a = torch.where(is_sphere, t_sph, dist_a)
    L_area = torch.where(is_sphere[..., None], spectra, L_area_tri)

    is_pt = kind == L_POINT
    is_area = kind == L_AREA
    L = (torch.where(is_pt[..., None], L_pt, zero)
         + torch.where(is_area[..., None], L_area, zero))
    wi = torch.where(is_area[..., None], wi_area, wi_point)
    pdf = torch.where(is_area, pdf_area, torch.ones((), device=dev))
    dist_out = torch.where(is_area, dist_a, dist)
    L = torch.where((pdf > 1e-12)[..., None], L, zero)
    return LightSample(L=L, wi=wi, pdf=torch.clamp(pdf, min=1e-12), dist=dist_out,
                       is_delta=~is_area)


def light_pdf(lights: LightsT, light_idx, p, wi):
    """Solid-angle pdf of sampling direction wi from light light_idx at
    p, for MIS with BSDF sampling. Point lights are delta lights (0);
    for triangle area lights the caller computes the pdf from the actual
    hit (area_tri_pdf), so this is 0 for them; sphere area lights seen
    from outside give the cone pdf."""
    light_idx = light_idx.long()
    kind = lights.kind[light_idx]
    params = lights.params[light_idx]
    dc = params[..., 2:5] - p
    dc2 = torch.clamp(torch.sum(dc * dc, -1), min=1e-12)
    radius = params[..., 5]
    sin2_max = radius * radius / dc2
    p_cone = uniform_cone_pdf(torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0)))
    is_sphere_area = (kind == L_AREA) & (params[..., 1] > 0.5)
    return torch.where(is_sphere_area & (sin2_max < 1.0), p_cone,
                       torch.zeros((), device=p.device))


def area_tri_pdf(lights: LightsT, light_idx, dist2, cos_theta):
    """Solid-angle pdf for hitting a triangle area light with a BSDF ray."""
    total_area = torch.clamp(lights.params[light_idx.long(), 0], min=1e-12)
    return dist2 / torch.clamp(torch.abs(cos_theta) * total_area, min=1e-9)


def area_emission(lights: LightsT, light_idx, ng, wo):
    """L_e leaving an emissive surface toward wo (reference
    core/light.h:135 DiffuseAreaLight::L)."""
    spectra = lights.spectra[light_idx.long()]
    emits = dot(ng, wo) > 0.0
    return torch.where((emits & (light_idx >= 0))[..., None], spectra,
                       torch.zeros((), device=ng.device))
