"""Device-side light table + sampling over wavefront batches.

Port of pbrt_tpu/lights/lighting.py (reference core/light.h:48-153,
lights/*.cpp): a closed-set table (kind + transforms + spectrum +
params [L, 12]) evaluated masked, plus host-built side structures
(EnvMap) for the image-driven lights, whose count is static per scene:

  POINT:      (reference lights/point.cpp)            -
  SPOT:       [0]=cosTotalWidth [1]=cosFalloffStart   (lights/spot.cpp:79)
  GONIO:      the angular image (EnvMap)              (goniometric.cpp:74)
  PROJECTION: [0]=cosTotalWidth, screen bounds [1..4], [5]=hither
              (projection.cpp:114), the projected image (EnvMap)
  DISTANT:    [0:3]=world direction toward the light  (distant.cpp:68)
  INFINITE:   the environment map (EnvMap), importance-sampled by
              luminance x sin(theta) (infinite.cpp:85-245)
  AREA:       [0]=total area [1]=is_sphere [2:5]=center [5]=radius
              [6]=tri_start [7]=tri_count              (diffuse.cpp:61)

The EnvMaps ride on the table (`LightsT.envs`), so every sampler and
integrator that takes the lights takes them too. Area lights sample
their triangle soup (quadric emitters other than full spheres are
tessellated at compile time) by an area-weighted CDF per light segment,
and full-sphere emitters sample the subtended cone analytically
(reference shapes/sphere.cpp Sample). Image lookups are nearest-texel,
as in the JAX package.

`sample_light` samples an incident direction at shading points;
`sample_light_ray` samples an emitted ray (photon shooting); `env_le`
is the radiance of escaped rays.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import (
    coordinate_system,
    cross,
    dot,
    length,
    normalize,
    spherical_phi,
    spherical_theta,
)
from pbrt_tpu_torch.core.sampling import (
    INV_PI,
    INV_TWOPI,
    Distribution2D,
    concentric_sample_disk,
    cosine_sample_hemisphere,
    f32_bits,
    uniform_cone_pdf,
    uniform_sample_cone,
    uniform_sample_sphere,
    uniform_sample_triangle,
)
from pbrt_tpu_torch.core.transform import xform_vector

L_POINT, L_SPOT, L_GONIO, L_PROJECTION, L_DISTANT, L_INFINITE, L_AREA = range(7)

BIG = 1e30


class EnvMap(NamedTuple):
    """Image side structure of a goniometric, projection or infinite
    light (host-built, device tensors); kind is kept on the host."""

    light_idx: int
    kind: int
    image: torch.Tensor       # [h, w, S] radiance spectra
    dist: Distribution2D      # importance over (u, v): luminance * sin(theta)


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
    envs: tuple = ()         # EnvMaps of the image-driven lights

    @property
    def n_lights(self):
        return self.kind.shape[0]


class LightSample(NamedTuple):
    L: torch.Tensor          # [H, S] incident radiance (before visibility)
    wi: torch.Tensor         # [H, 3]
    pdf: torch.Tensor        # [H] (solid angle; delta lights use 1)
    dist: torch.Tensor       # [H] distance to the light point
    is_delta: torch.Tensor   # [H] bool


def spot_falloff(cos_t, cos_width, cos_falloff):
    """reference lights/spot.cpp Falloff."""
    d = torch.clamp((cos_t - cos_width) / torch.clamp(cos_falloff - cos_width, min=1e-9),
                    0.0, 1.0)
    zero, one = torch.zeros((), device=cos_t.device), torch.ones((), device=cos_t.device)
    return torch.where(cos_t < cos_width, zero,
                       torch.where(cos_t > cos_falloff, one, (d * d) * (d * d)))


def _env_lookup(env: EnvMap, u, v):
    """Nearest texel at (u, v) in [0, 1]^2."""
    h, w = env.image.shape[0], env.image.shape[1]
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return env.image[y, x]


def env_le(lights: LightsT, d_world):
    """Background radiance of escaped rays: the sum over the infinite
    lights. d_world: [R, 3] (need not be normalized)."""
    out = torch.zeros(d_world.shape[:-1] + (spec.N_BINS,), device=d_world.device)
    for env in lights.envs:
        if env.kind != L_INFINITE:
            continue
        li = env.light_idx
        d = normalize(xform_vector(lights.w2l[li], d_world))
        u = spherical_phi(d) * INV_TWOPI
        v = spherical_theta(d) * INV_PI
        out = out + lights.spectra[li] * _env_lookup(env, u, v)
    return out


def _env_direction(lights: LightsT, env: EnvMap, u1, u2, min_sin: float):
    """Importance-sample env's map: (world direction toward the light,
    (u, v), pdf over (u, v), sin theta clamped below by min_sin)."""
    (u, v), pdf_uv = env.dist.sample_continuous(u1, u2)
    theta = v * math.pi
    phi = u * 2.0 * math.pi
    sin_t = torch.sin(theta)
    if min_sin > 0.0:
        sin_t = torch.clamp(sin_t, min=min_sin)
    d_l = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta)], -1)
    return normalize(xform_vector(lights.l2w[env.light_idx], d_l)), (u, v), pdf_uv, sin_t


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
    keys = (seg_start << 32) | f32_bits(lights.al_cdf)
    j = torch.searchsorted(keys, (tri_start << 32) | f32_bits(x))
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
    w2l = lights.w2l[light_idx]
    spectra = lights.spectra[light_idx]
    params = lights.params[light_idx]

    # POINT / SPOT / GONIO / PROJECTION share the position falloff
    light_pos = l2w[..., :3, 3]
    d_to_light = light_pos - p
    dist2 = torch.clamp(torch.sum(d_to_light * d_to_light, -1), min=1e-12)
    dist = torch.sqrt(dist2)
    wi_point = d_to_light / dist[..., None]
    L_pt = spectra / dist2[..., None]

    # SPOT: falloff about the light's +z
    wl = normalize(xform_vector(w2l, -wi_point))
    falloff = spot_falloff(wl[..., 2], params[..., 0], params[..., 1])

    # PROJECTION: the screen window at z = 1, params [1..4] = x0 x1 y0 y1
    px = wl[..., 0] / torch.clamp(wl[..., 2], min=1e-9)
    py = wl[..., 1] / torch.clamp(wl[..., 2], min=1e-9)
    in_proj = ((wl[..., 2] > 0) & (px >= params[..., 1]) & (px <= params[..., 2])
               & (py >= params[..., 3]) & (py <= params[..., 4]))
    proj_scale = in_proj.to(torch.float32)

    # DISTANT
    wi_dist = normalize(params[..., 0:3])

    # INFINITE: importance-sample the env map
    wi_inf = torch.zeros((H, 3), device=dev)
    L_inf = torch.zeros_like(spectra)
    pdf_inf = torch.zeros((H,), device=dev)
    for env in lights.envs:
        if env.kind != L_INFINITE:
            continue
        wi_e, (u, v), pdf_uv, sin_t = _env_direction(lights, env, u1, u2, 0.0)
        pdf_e = pdf_uv / torch.clamp(2.0 * math.pi * math.pi * sin_t, min=1e-9)
        Le = lights.spectra[env.light_idx] * _env_lookup(env, u, v)
        sel = light_idx == env.light_idx
        wi_inf = torch.where(sel[..., None], wi_e, wi_inf)
        L_inf = torch.where(sel[..., None], Le, L_inf)
        pdf_inf = torch.where(sel, pdf_e, pdf_inf)

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
    is_spot = kind == L_SPOT
    is_gonio = kind == L_GONIO
    is_proj = kind == L_PROJECTION
    is_distant = kind == L_DISTANT
    is_inf = kind == L_INFINITE
    is_area = kind == L_AREA

    # goniometric scale: the luminance of the angular image toward p
    gonio_scale = torch.ones((H,), device=dev)
    proj_img_scale = torch.ones_like(spectra)
    for env in lights.envs:
        sel = light_idx == env.light_idx
        if env.kind == L_GONIO:
            u = spherical_phi(wl) * INV_TWOPI
            v = spherical_theta(wl) * INV_PI
            gonio_scale = torch.where(sel, spec.y(_env_lookup(env, u, v)), gonio_scale)
        elif env.kind == L_PROJECTION:
            x0, x1, y0, y1 = (params[..., k] for k in (1, 2, 3, 4))
            u = (px - x0) / torch.clamp(x1 - x0, min=1e-9)
            v = (py - y0) / torch.clamp(y1 - y0, min=1e-9)
            val = _env_lookup(env, torch.clamp(u, 0, 1), torch.clamp(v, 0, 1))
            proj_img_scale = torch.where(sel[..., None], val, proj_img_scale)

    L = (torch.where(is_pt[..., None], L_pt, zero)
         + torch.where(is_spot[..., None], L_pt * falloff[..., None], zero)
         + torch.where(is_gonio[..., None], L_pt * gonio_scale[..., None], zero)
         + torch.where(is_proj[..., None], L_pt * proj_scale[..., None] * proj_img_scale, zero)
         + torch.where(is_distant[..., None], spectra, zero)
         + torch.where(is_inf[..., None], L_inf, zero)
         + torch.where(is_area[..., None], L_area, zero))
    wi = torch.where(is_distant[..., None], wi_dist,
                     torch.where(is_inf[..., None], wi_inf,
                                 torch.where(is_area[..., None], wi_area, wi_point)))
    pdf = torch.where(is_inf, pdf_inf, torch.where(is_area, pdf_area, torch.ones((), device=dev)))
    dist_out = torch.where(is_distant | is_inf, torch.full((), BIG, device=dev),
                           torch.where(is_area, dist_a, dist))
    L = torch.where((pdf > 1e-12)[..., None], L, zero)
    return LightSample(L=L, wi=wi, pdf=torch.clamp(pdf, min=1e-12), dist=dist_out,
                       is_delta=~(is_inf | is_area))


def light_pdf(lights: LightsT, light_idx, p, wi):
    """Solid-angle pdf of sampling direction wi from light light_idx at
    p, for MIS with BSDF sampling. Point, spot, goniometric, projection
    and distant lights are delta lights (0); infinite lights give their
    map's pdf over (u, v) / (2 pi^2 sin theta); for triangle area lights
    the caller computes the pdf from the actual hit (area_tri_pdf), so
    this is 0 for them; sphere area lights seen from outside give the
    cone pdf."""
    light_idx = light_idx.long()
    kind = lights.kind[light_idx]
    params = lights.params[light_idx]
    pdf = torch.zeros(p.shape[:-1], device=p.device)
    for env in lights.envs:
        if env.kind != L_INFINITE:
            continue
        d = normalize(xform_vector(lights.w2l[env.light_idx], wi))
        theta = spherical_theta(d)
        phi = spherical_phi(d)
        sin_t = torch.clamp(torch.sin(theta), min=1e-9)
        p_uv = env.dist.pdf(phi * INV_TWOPI, theta * INV_PI)
        pdf = torch.where(light_idx == env.light_idx,
                          p_uv / (2.0 * math.pi * math.pi * sin_t), pdf)
    dc = params[..., 2:5] - p
    dc2 = torch.clamp(torch.sum(dc * dc, -1), min=1e-12)
    radius = params[..., 5]
    sin2_max = radius * radius / dc2
    p_cone = uniform_cone_pdf(torch.sqrt(torch.clamp(1.0 - sin2_max, min=0.0)))
    is_sphere_area = (kind == L_AREA) & (params[..., 1] > 0.5)
    return torch.where(is_sphere_area & (sin2_max < 1.0), p_cone, pdf)


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


class LightRaySample(NamedTuple):
    """Emitted-ray sample (the reference's second Sample_L overload,
    core/light.h:70)."""

    o: torch.Tensor       # [H, 3] origin
    d: torch.Tensor       # [H, 3] unit direction
    alpha: torch.Tensor   # [H, S] L / pdf of the light's own sampling


def sample_light_ray(lights: LightsT, light_idx, world_c, world_rad: float,
                     u1, u2, u3, u4) -> LightRaySample:
    """Sample an emitted photon ray from light light_idx per lane. alpha
    holds L / pdf for the light's own sampling; the caller divides by the
    pick pmf (reference photonshooter.cpp:262 alpha = Le / (pdf *
    lightPdf)). world_c [3], world_rad: the scene's bounding sphere,
    which a distant light's disk of origins covers."""
    light_idx = light_idx.long()
    H = light_idx.shape[0]
    dev = u1.device
    zero = torch.zeros((), device=dev)
    kind = lights.kind[light_idx]
    l2w = lights.l2w[light_idx]
    spectra = lights.spectra[light_idx]
    params = lights.params[light_idx]
    light_pos = l2w[..., :3, 3]

    # POINT: uniform sphere, pdf = 1/4pi (lights/point.cpp)
    d_sph = uniform_sample_sphere(u1, u2)
    a_point = spectra * (4.0 * math.pi)

    # SPOT: uniform cone around the light's +z (lights/spot.cpp)
    cos_width = params[..., 0]
    d_cone_l = uniform_sample_cone(u1, u2, cos_width)
    d_spot = (d_cone_l[..., 0:1] * l2w[..., :3, 0] + d_cone_l[..., 1:2] * l2w[..., :3, 1]
              + d_cone_l[..., 2:3] * l2w[..., :3, 2])
    fall = spot_falloff(d_cone_l[..., 2], params[..., 0], params[..., 1])
    a_spot = spectra * fall[..., None] / uniform_cone_pdf(cos_width)[..., None]

    # DISTANT: a disk of the world's radius, fixed direction (lights/distant.cpp)
    wi_dist = normalize(params[..., 0:3])   # toward the light
    v1, v2 = coordinate_system(wi_dist)
    dx, dy = concentric_sample_disk(u1, u2)
    p_disk = world_c + world_rad * (dx[..., None] * v1 + dy[..., None] * v2 + wi_dist)
    a_distant = spectra * (math.pi * world_rad * world_rad)

    # AREA: a point by the triangle CDF (or on the sphere) + a cosine
    # hemisphere direction (lights/diffuse.cpp)
    AT = lights.al_v0.shape[0]
    if AT > 0:
        tri_j = _pick_area_tri(lights, params[..., 6].to(torch.int64),
                               params[..., 7].to(torch.int64), u3 * 0.9999999)
        e1t, e2t = lights.al_e1[tri_j], lights.al_e2[tri_j]
        b0, b1 = uniform_sample_triangle(u1, u2)
        p_tri = lights.al_v0[tri_j] + b0[..., None] * e1t + b1[..., None] * e2t
        n_tri = cross(e1t, e2t)
        n_tri = n_tri / torch.clamp(length(n_tri), min=1e-12)[..., None]
    else:
        p_tri = torch.zeros((H, 3), device=dev)
        n_tri = torch.zeros((H, 3), device=dev)
        n_tri[:, 2] = 1.0
    sph_n = uniform_sample_sphere(u1, u2)
    p_sph = params[..., 2:5] + params[..., 5][..., None] * sph_n
    is_sphere = (params[..., 1] > 0.5)[..., None]
    p_area = torch.where(is_sphere, p_sph, p_tri)
    n_area = torch.where(is_sphere, sph_n, n_tri)
    d_cos = cosine_sample_hemisphere(u3, u4)
    ax1, ax2 = coordinate_system(n_area)
    d_area = d_cos[..., 0:1] * ax1 + d_cos[..., 1:2] * ax2 + d_cos[..., 2:3] * n_area
    # pdf = (1/area) (cos/pi): alpha = L area pi / cos, and the cosine
    # cancels against the emitted power's
    a_area = spectra * (math.pi * torch.clamp(params[..., 0], min=1e-12))[..., None]

    # INFINITE: an importance-sampled direction, origins on a disk of the
    # world's radius facing it (uniform directions without a map)
    d_inf = -d_sph
    a_inf = spectra * (4.0 * math.pi * math.pi * world_rad * world_rad)
    for env in lights.envs:
        if env.kind != L_INFINITE:
            continue
        w_to, (uu, vv), pdf_uv, sin_t = _env_direction(lights, env, u1, u2, 1e-6)
        pdf_dir = pdf_uv / (2.0 * math.pi * math.pi * sin_t)
        Le = lights.spectra[env.light_idx] * _env_lookup(env, uu, vv)
        sel = (light_idx == env.light_idx)[..., None]
        d_inf = torch.where(sel, -w_to, d_inf)
        a_inf = torch.where(
            sel, Le * (math.pi * world_rad * world_rad
                       / torch.clamp(pdf_dir, min=1e-12))[..., None], a_inf)
    v1i, v2i = coordinate_system(-d_inf)
    dxi, dyi = concentric_sample_disk(u3, u4)
    p_inf = world_c + world_rad * (dxi[..., None] * v1i + dyi[..., None] * v2i - d_inf)

    # goniometric and projection lights emit as point lights
    is_pt = ((kind == L_POINT) | (kind == L_GONIO) | (kind == L_PROJECTION))[..., None]
    is_spot = (kind == L_SPOT)[..., None]
    is_distant = (kind == L_DISTANT)[..., None]
    is_inf = (kind == L_INFINITE)[..., None]
    is_area = (kind == L_AREA)[..., None]
    o = torch.where(is_distant, p_disk,
                    torch.where(is_inf, p_inf, torch.where(is_area, p_area, light_pos)))
    d = torch.where(is_spot, d_spot,
                    torch.where(is_distant, -wi_dist,
                                torch.where(is_inf, d_inf,
                                            torch.where(is_area, d_area, d_sph))))
    alpha = (torch.where(is_pt, a_point, zero) + torch.where(is_spot, a_spot, zero)
             + torch.where(is_distant, a_distant, zero) + torch.where(is_inf, a_inf, zero)
             + torch.where(is_area, a_area, zero))
    return LightRaySample(o=o, d=normalize(d), alpha=alpha)
