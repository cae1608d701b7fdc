"""Device-side light table + sampling over wavefront batches.

Port of pbrt_tpu/lights/lighting.py for point lights (reference
lights/point.cpp) and diffuse area lights on triangle meshes (reference
lights/diffuse.cpp). The table layout is the reference's (kind +
transforms + spectrum + params [L, 12]); area lights sample their
triangle soup by an area-weighted CDF per light segment:

  AREA params: [0]=total area [1]=is_sphere [2:5]=center [5]=radius
               [6]=tri_start [7]=tri_count

The other light kinds are not yet ported.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pbrt_tpu_torch.core.geometry import cross, dot, length
from pbrt_tpu_torch.core.sampling import uniform_sample_triangle

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
        # smallest j in [start, start+count) with cdf[j] >= u1' (masked pass)
        idxs = torch.arange(AT, device=dev)
        in_seg = (idxs[None, :] >= tri_start[:, None]) & (
            idxs[None, :] < (tri_start + tri_count)[:, None])
        passed = in_seg & (lights.al_cdf[None, :] >= u1[:, None] * 0.9999999)
        first = torch.argmax(passed.to(torch.int32), -1)
        tri_j = torch.where(torch.any(passed, -1), first, tri_start)
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
        L_area = torch.where(emits[..., None], spectra, zero)
    else:
        wi_area = torch.zeros((H, 3), device=dev)
        pdf_area = torch.zeros((H,), device=dev)
        dist_a = torch.full((H,), BIG, device=dev)
        L_area = torch.zeros_like(spectra)

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
    hit (area_tri_pdf), so this is 0 for every ported kind."""
    return torch.zeros(p.shape[:-1], device=p.device)


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
