"""Realistic lens camera + SML contrast autofocus.

Port of pbrt_tpu/cameras/realistic.py (reference cameras/realistic.cpp,
the CS348B lens camera): a lens spec file of rows (radius, z-spacing, n,
aperture); a film point is traced through a concentric-sampled point of
the rear element and refracted element by element (sphere, or a plane
aperture stop) by Snell's law; the weight is
pi (A/2)^2 cos^4(theta) / filmdist^2 (realistic.cpp:135-246).

The element loop is unrolled over the lens rows: a ray that misses an
aperture keeps weight 0 and is still traced, as in the JAX package.
The exit ray has tmax = inf (both accelerators clamp it).

Autofocus renders zone crops through the scene's radiance function and
hill-climbs the film distance on Sum-Modified-Laplacian sharpness with
a log-parabola peak fit (:254-424). Its jitter is drawn on the host from
np.random.RandomState exactly as the JAX package draws it, so both
packages trace identical film samples; the port traces the samples of
all of a scan's film distances in a few large batches instead of one
call per distance and sample. Each zone restarts from the starting
film distance and the last zone's pick wins (ROADMAP R22).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.core.error import info, severe, warning
from pbrt_tpu_torch.core.geometry import Ray, dot, normalize
from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import Transform, xform_point_affine, xform_vector
from pbrt_tpu_torch.scene.paramset import ParamSet


@dataclass
class LensSystem:
    # per element in file order (front first); rays traverse rear -> front
    radius: np.ndarray      # [E]
    z_dist: np.ndarray      # [E] vertex z (0 at the front element, negative behind)
    n_refr: np.ndarray      # [E] refraction index (0 -> air)
    aperture: np.ndarray    # [E] diameter
    film_diag: float
    film_dist: float        # film to rear vertex distance
    af_zones: List[Tuple[float, float, float, float]]


def parse_lens_file(path: str, aperture_diameter: float) -> Tuple[np.ndarray, ...]:
    """Rows: radius, thickness (z to the next row), n, aperture; a row of
    radius 0 is the stop, whose aperture is aperture_diameter
    (reference realistic.cpp:65-94) -> (radius, z, n, aperture)."""
    rows = []
    zdist = 0.0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            r, z, n, a = (float(x) for x in line.split()[:4])
            if abs(r) <= 0:
                a = aperture_diameter
            rows.append((r, zdist, n, a))
            zdist -= z
    if not rows:
        severe(f"empty lens spec file {path}")
    arr = np.asarray(rows, np.float64)
    return arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]


def _read_af_zones(path: str):
    zones = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = [float(x) for x in line.split()]
                if len(v) >= 4:
                    zones.append((v[0], v[1], v[2], v[3]))
    except OSError as e:
        warning(f"cannot open autofocus zone file {path}: {e}")
    return zones


def make_realistic_camera(params: ParamSet, cam_to_world: Transform,
                          xres: int, yres: int, sopen: float, sclose: float):
    from pbrt_tpu_torch.cameras.cameras import CAM_REALISTIC, Camera

    specfile = params.find_one_filename("specfile", "")
    filmdistance = params.find_one_float("filmdistance", 70.0)
    ap_diam = params.find_one_float("aperture_diameter", 1.0)
    filmdiag = params.find_one_float("filmdiag", 35.0)
    affile = params.find_one_filename("af_zones", "")
    params.find_one_float("hither", -1)
    params.find_one_float("yon", -1)
    if not specfile:
        severe("No lens spec file supplied to realistic camera")
    radius, zd, nr, ap = parse_lens_file(specfile, ap_diam)
    zones = _read_af_zones(affile) if affile else []
    params.report_unused('in camera "realistic"')
    lens = LensSystem(radius=radius, z_dist=zd, n_refr=nr, aperture=ap,
                      film_diag=filmdiag, film_dist=filmdistance, af_zones=zones)
    return Camera(kind=CAM_REALISTIC, cam_to_world=cam_to_world.m.astype(np.float32),
                  raster_to_camera=np.eye(4, dtype=np.float32), shutter_open=sopen,
                  shutter_close=sclose, width=xres, height=yres, lens=lens)


def realistic_generate_rays(camera, px, py, u1, u2, u_time,
                            film_dist: Optional[float] = None):
    """Batched GenerateRay (reference realistic.cpp:135-246) ->
    (Ray [N], weight [N]); rays that miss an aperture get weight 0."""
    lens: LensSystem = camera.lens
    E = len(lens.radius)
    H = px.shape[0]
    dev = px.device
    fd = float(lens.film_dist if film_dist is None else film_dist)
    zero = torch.zeros((), device=dev)

    scale = float(lens.film_diag / np.sqrt(camera.width ** 2 + camera.height ** 2))
    cam_x = -(px - camera.width / 2.0) * scale
    cam_y = (py - camera.height / 2.0) * scale

    first = E - 1  # the rear element (film side)
    first_dist = float(lens.z_dist[first])
    full_film = first_dist - fd
    if lens.radius[first] < 0.0:
        x = np.sqrt(lens.radius[first] ** 2 + (lens.aperture[first] / 2) ** 2)
        first_dist = float(first_dist + lens.radius[first] + x)

    lu, lv = concentric_sample_disk(u1, u2)
    a2 = float(lens.aperture[first] / 2.0)
    lu, lv = lu * a2, lv * a2

    p_cam = torch.stack([cam_x, cam_y, torch.full((H,), full_film, device=dev)], -1)
    p_lens = torch.stack([lu, lv, torch.full((H,), first_dist, device=dev)], -1)
    d = normalize(p_lens - p_cam)
    cos_t = dot(d, torch.tensor([0.0, 0.0, -1.0], device=dev))
    w = (math.pi * a2 * a2 / (fd * fd)) * torch.pow(torch.abs(cos_t), 4.0)

    o, dd = p_cam, d
    alive = torch.ones((H,), dtype=torch.bool, device=dev)
    for i in range(E - 1, -1, -1):
        R = float(lens.radius[i])
        zv = float(lens.z_dist[i])
        ap_r = float(lens.aperture[i] / 2.0)
        if R != 0.0:
            C = torch.tensor([0.0, 0.0, zv - R], device=dev)
            oc = o - C
            a_q = torch.sum(dd * dd, -1)
            b_q = 2.0 * torch.sum(oc * dd, -1)
            c_q = torch.sum(oc * oc, -1) - R * R
            disc = b_q * b_q - 4.0 * a_q * c_q
            ok = disc >= 0.0
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            t1 = (-b_q - sq) / (2.0 * torch.clamp(a_q, min=1e-12))
            t2 = (-b_q + sq) / (2.0 * torch.clamp(a_q, min=1e-12))
            t = torch.where((t1 > 0) & (t2 > 0), torch.minimum(t1, t2),
                            torch.where(t1 > 0, t1, t2))
            ok = ok & (t > 0)
            P = o + t[..., None] * dd
            ok = ok & (torch.hypot(P[..., 0], P[..., 1]) <= ap_r)
            N = normalize(P - C)
            if R > 0:
                N = -N
            cos_th = dot(dd, N)
            n1 = float(lens.n_refr[i])
            n2 = float(lens.n_refr[i - 1]) if i != 0 else 1.0
            if n2 == 0.0:
                n2 = 1.0
            if n1 != n2 and n1 != 0.0:
                my = n1 / n2
                k = 1.0 - my * my * (1.0 - cos_th * cos_th)
                ok = ok & (k >= 0.0)
                T = my * dd - (my * cos_th + torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * N
                o = torch.where(ok[..., None], P, o)
                dd = torch.where(ok[..., None], normalize(T), dd)
            else:
                o = torch.where(ok[..., None], P, o)
            alive = alive & ok
        else:  # the aperture stop: a plane at zv
            dz = dd[..., 2]
            t = (zv - o[..., 2]) / torch.where(torch.abs(dz) > 1e-12, dz,
                                               torch.full((), 1e-12, device=dev))
            P = o + t[..., None] * dd
            alive = alive & (torch.hypot(P[..., 0], P[..., 1]) <= ap_r)

    c2w = torch.as_tensor(camera.cam_to_world, dtype=torch.float32, device=dev)
    ray = Ray(o=xform_point_affine(c2w[None], o), d=normalize(xform_vector(c2w[None], dd)),
              tmin=torch.zeros((H,), device=dev),
              tmax=torch.full((H,), float("inf"), device=dev),
              time=camera.shutter_open + u_time * (camera.shutter_close - camera.shutter_open))
    return ray, torch.where(alive, w, zero)


# ---------------------------------------------------------------------------
# Autofocus (reference realistic.cpp:254-424)

def sml(rgb: np.ndarray, step: int = 2) -> float:
    """Sum-Modified-Laplacian sharpness (reference SML :254-268)."""
    c = rgb[step:-step, step:-step]
    xm = rgb[step:-step, : -2 * step]
    xp = rgb[step:-step, 2 * step:]
    ym = rgb[: -2 * step, step:-step]
    yp = rgb[2 * step:, step:-step]
    ml = np.abs(2 * c - xm - xp) + np.abs(2 * c - ym - yp)
    return float(ml.sum())


# lanes of one radiance call in zone_sharpness (the render driver's tile)
AF_LANES = 1 << 16


def _cat_rays(rays):
    return Ray(*(torch.cat(f) for f in zip(*rays)))


def zone_sharpness(camera, film, li_fn, zone, fdists, seed: int, spp: int, device):
    """SML of one AF zone's crop rendered at each film distance of fdists
    with spp samples a pixel -> list of floats. The film samples are the
    JAX package's host jitter streams, one per sample index and shared
    by every distance; the rays of several (distance, sample) pairs go
    to the radiance function in one batch of up to AF_LANES lanes, each
    lane keyed by its pixel in the crop and its sample index as in a
    call of its own, so each distance's crop equals the JAX package's
    one-call-a-sample render (summed over samples in the same order)."""
    x0f, x1f, y0f, y1f = zone
    x0 = int(x0f * film.xres)
    x1 = max(x0 + 8, int(x1f * film.xres))
    y0 = int(y0f * film.yres)
    y1 = max(y0 + 8, int(y1f * film.yres))
    gx, gy = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1), indexing="xy")
    n = gx.size
    samples = []
    for s in range(spp):
        h = (s * 0x9E3779B9 + seed) & 0xFFFFFFFF   # uint32 arithmetic, as the JAX package's
        rng = np.random.RandomState(h & 0x7FFFFFFF)
        jx = rng.rand(*gx.shape).astype(np.float32)
        jy = rng.rand(*gy.shape).astype(np.float32)
        samples.append([torch.as_tensor(x, device=device) for x in (
            (gx + jx).ravel().astype(np.float32), (gy + jy).ravel().astype(np.float32),
            rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32))])
    zeros = torch.zeros((n,), device=device)
    pixel = torch.arange(n, dtype=torch.int64, device=device)
    s2rgb = spectrum.S2RGB.T.astype(np.float32)
    jobs = [(k, s) for k in range(len(fdists)) for s in range(spp)]
    acc = np.zeros((len(fdists),) + gx.shape + (3,), np.float32)
    per = max(1, AF_LANES // n)
    for j0 in range(0, len(jobs), per):
        chunk = jobs[j0:j0 + per]
        rays, ws = zip(*(realistic_generate_rays(camera, *samples[s], zeros,
                                                 film_dist=float(fdists[k]))
                         for k, s in chunk))
        sidx = torch.cat([torch.full_like(pixel, s) for _, s in chunk])
        L = li_fn(_cat_rays(rays), pixel.repeat(len(chunk)), sidx, seed)
        rgb = (L * torch.cat(ws)[..., None]).cpu().numpy() @ s2rgb
        for i, (k, _) in enumerate(chunk):
            acc[k] += rgb[i * n:(i + 1) * n].reshape(acc.shape[1:])
    return [sml(a / spp) for a in acc]


def autofocus(scene, camera, film, li_fn, seed: int = 0, spp: int = 16):
    """Per AF zone: scan 5 film distances around the starting one,
    refine 5 more between the best one's neighbours, and interpolate
    the peak by a parabola in log SML; sets camera.lens.film_dist
    (reference :370-424)."""
    lens: LensSystem = camera.lens
    if not lens.af_zones:
        return
    device = scene.geom.tri_v0.device
    base = lens.film_dist
    for zi, zone in enumerate(lens.af_zones):
        cands = base * np.asarray([0.85, 0.925, 1.0, 1.075, 1.15])
        k = int(np.argmax(zone_sharpness(camera, film, li_fn, zone, cands, seed, spp, device)))
        cands2 = np.linspace(cands[max(0, k - 1)], cands[min(len(cands) - 1, k + 1)], 5)
        scores2 = zone_sharpness(camera, film, li_fn, zone, cands2, seed, spp, device)
        k2 = int(np.argmax(scores2))
        if 0 < k2 < len(cands2) - 1:   # log-parabola peak (reference :415-423)
            f0, f1, f2 = (np.log(max(scores2[k2 + j], 1e-12)) for j in (-1, 0, 1))
            denom = f0 - 2 * f1 + f2
            off = 0.5 * (f0 - f2) / denom if abs(denom) > 1e-12 else 0.0
            best = cands2[k2] + np.clip(off, -1, 1) * (cands2[1] - cands2[0])
        else:
            best = cands2[k2]
        info(f"autofocus zone {zi}: film distance {base:.3f} -> {best:.3f}")
        lens.film_dist = float(best)
