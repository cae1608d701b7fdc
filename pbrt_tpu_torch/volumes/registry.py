"""Volume regions as a closed-set device table.

Port of pbrt_tpu/volumes/registry.py (reference core/volume.h:53-115,
volumes/{homogeneous,volumegrid,exponential,rainbow}.cpp): one table
evaluated masked over ray-march sample batches. Multiple Volume
statements aggregate by summation where regions overlap (reference
core/volume.h:105 AggregateVolume).

Kinds and params layout (params [V, 8]):
  HOMOGENEOUS: (reference volumes/homogeneous.h)         -
  GRID:        densities in `grid`, dims in `grid_dims`  (volumegrid.cpp:63)
  EXPONENTIAL: [0]=a [1]=b [2:5]=updir                   (exponential.cpp:42)
  RAINBOW:     a homogeneous density region; its angle-to-wavelength
               transfer (rainbow_reflection) is applied by the photon
               volume integrator

The region kinds and grid dims are also kept on the host (host_kind,
host_dims), so the per-region branches are chosen without a device read.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import warning
from pbrt_tpu_torch.core.geometry import dot
from pbrt_tpu_torch.core.sampling import phase_hg, phase_mie_hazy
from pbrt_tpu_torch.core.transform import xform_point_affine, xform_vector
from pbrt_tpu_torch.scene.records import VolumeRecord

V_HOMOGENEOUS, V_GRID, V_EXPONENTIAL, V_RAINBOW = range(4)

S = spec.N_BINS


class VolumeT(NamedTuple):
    """Device volume-region table. D = max grid voxel count (padded)."""

    kind: torch.Tensor       # [V] int32
    w2v: torch.Tensor        # [V, 4, 4] world-to-volume
    lo: torch.Tensor         # [V, 3] volume-space bbox
    hi: torch.Tensor         # [V, 3]
    sigma_a: torch.Tensor    # [V, S]
    sigma_s: torch.Tensor    # [V, S]
    le: torch.Tensor         # [V, S]
    g: torch.Tensor          # [V] HG asymmetry
    params: torch.Tensor     # [V, 8]
    grid: torch.Tensor       # [V, D] flattened densities (zeros if not grid)
    grid_dims: torch.Tensor  # [V, 3] int32 (nx, ny, nz)
    host_kind: tuple = ()    # the kinds, on the host
    host_dims: tuple = ()    # the grid dims, on the host

    @property
    def n_volumes(self):
        return len(self.host_kind)

    @staticmethod
    def make(device, **arrays):
        """From host arrays (NumPy or CPU tensors) named like the device
        fields; the host fields are derived from kind and grid_dims."""
        kw = {k: torch.as_tensor(v).to(device).contiguous() for k, v in arrays.items()}
        return VolumeT(**kw, host_kind=tuple(int(k) for k in np.asarray(arrays["kind"])),
                       host_dims=tuple(tuple(int(x) for x in row)
                                       for row in np.asarray(arrays["grid_dims"])))


def build_volumes(records: List[VolumeRecord], device) -> Optional[VolumeT]:
    """Lower Volume records to the device table (host side)."""
    if not records:
        return None
    kinds, w2v, lo, hi, sa, ss, le, g, params, grids, dims = ([] for _ in range(11))
    for rec in records:
        p = rec.params
        name = rec.kind
        pr = np.zeros(8, np.float32)
        grid = np.zeros(0, np.float32)
        gd = (0, 0, 0)
        if name == "homogeneous" or name == "rainbow":
            kind = V_RAINBOW if name == "rainbow" else V_HOMOGENEOUS
        elif name == "volumegrid":
            kind = V_GRID
            nx = p.find_one_int("nx", 1)
            ny = p.find_one_int("ny", 1)
            nz = p.find_one_int("nz", 1)
            data = p.find_float("density")
            if data is None:
                warning("No \"density\" values provided for volume grid?")
                continue
            if len(data) != nx * ny * nz:
                warning(f"VolumeGridDensity has {len(data)} density values but "
                        f"nx*ny*nz = {nx * ny * nz}")
                continue
            grid = np.asarray(data, np.float32)
            gd = (nx, ny, nz)
        elif name == "exponential":
            kind = V_EXPONENTIAL
            pr[0] = p.find_one_float("a", 1.0)
            pr[1] = p.find_one_float("b", 1.0)
            up = np.asarray(p.find_one_vector("updir", [0.0, 1.0, 0.0]), np.float32)
            pr[2:5] = up / max(np.linalg.norm(up), 1e-12)
        else:
            warning(f'Volume "{name}" unknown.')
            continue
        p0 = np.asarray(p.find_one_point("p0", [0.0, 0.0, 0.0]), np.float32)
        p1 = np.asarray(p.find_one_point("p1", [1.0, 1.0, 1.0]), np.float32)
        sig_a = p.find_one_spectrum("sigma_a", spec.from_rgb(np.ones(3, np.float32)))
        sig_s = p.find_one_spectrum("sigma_s", spec.from_rgb(np.ones(3, np.float32)))
        lev = p.find_one_spectrum("Le", spec.from_rgb(np.zeros(3, np.float32)))
        gv = p.find_one_float("g", 0.0)
        p.report_unused(f'in volume "{name}"')
        kinds.append(kind)
        w2v.append(rec.v2w.inverse().m.astype(np.float32))
        lo.append(np.minimum(p0, p1))
        hi.append(np.maximum(p0, p1))
        sa.append(np.asarray(sig_a, np.float32))
        ss.append(np.asarray(sig_s, np.float32))
        le.append(np.asarray(lev, np.float32))
        g.append(gv)
        params.append(pr)
        grids.append(grid)
        dims.append(gd)
    if not kinds:
        return None
    grid_arr = np.zeros((len(kinds), max(1, max(gr.size for gr in grids))), np.float32)
    for i, gr in enumerate(grids):
        grid_arr[i, : gr.size] = gr
    return VolumeT.make(
        device, kind=np.asarray(kinds, np.int32), w2v=np.stack(w2v), lo=np.stack(lo),
        hi=np.stack(hi), sigma_a=np.stack(sa), sigma_s=np.stack(ss), le=np.stack(le),
        g=np.asarray(g, np.float32), params=np.stack(params), grid=grid_arr,
        grid_dims=np.asarray(dims, np.int32).reshape(len(kinds), 3))


# ---------------------------------------------------------------------------
# Device-side evaluation (all [P]-batched over sample points)

def _density(vol: VolumeT, vi: int, pv):
    """Density multiplier of region vi at volume-space points pv [P, 3]."""
    kind = vol.host_kind[vi]
    lo, hi = vol.lo[vi], vol.hi[vi]
    inside = torch.all((pv >= lo) & (pv <= hi), -1)
    if kind == V_GRID:
        nx, ny, nz = vol.host_dims[vi]
        ext = torch.clamp(hi - lo, min=1e-12)
        # grid coords with trilinear interpolation (reference volumegrid.cpp Density)
        gp = (pv - lo) / ext * torch.tensor([nx, ny, nz], dtype=torch.float32,
                                            device=pv.device) - 0.5
        gx = torch.clamp(gp[..., 0], 0.0, nx - 1.0)
        gy = torch.clamp(gp[..., 1], 0.0, ny - 1.0)
        gz = torch.clamp(gp[..., 2], 0.0, nz - 1.0)
        x0 = torch.clamp(torch.floor(gx).long(), 0, max(nx - 2, 0))
        y0 = torch.clamp(torch.floor(gy).long(), 0, max(ny - 2, 0))
        z0 = torch.clamp(torch.floor(gz).long(), 0, max(nz - 2, 0))
        tx, ty, tz = gx - x0, gy - y0, gz - z0
        flat = vol.grid[vi]

        def d(ix, iy, iz):
            return flat[torch.clamp((iz * ny + iy) * nx + ix, 0, nx * ny * nz - 1)]

        x1 = torch.clamp(x0 + 1, max=nx - 1)
        y1 = torch.clamp(y0 + 1, max=ny - 1)
        z1 = torch.clamp(z0 + 1, max=nz - 1)
        d00 = d(x0, y0, z0) * (1 - tx) + d(x1, y0, z0) * tx
        d10 = d(x0, y1, z0) * (1 - tx) + d(x1, y1, z0) * tx
        d01 = d(x0, y0, z1) * (1 - tx) + d(x1, y0, z1) * tx
        d11 = d(x0, y1, z1) * (1 - tx) + d(x1, y1, z1) * tx
        d0 = d00 * (1 - ty) + d10 * ty
        d1 = d01 * (1 - ty) + d11 * ty
        dens = d0 * (1 - tz) + d1 * tz
    elif kind == V_EXPONENTIAL:
        a, b = vol.params[vi, 0], vol.params[vi, 1]
        h = dot(pv - lo, vol.params[vi, 2:5])
        dens = a * torch.exp(-b * h)
    else:
        dens = torch.ones(pv.shape[:-1], device=pv.device)
    return torch.where(inside, dens, torch.zeros((), device=pv.device))


def sigma_at(vol: VolumeT, p_world):
    """(sigma_a, sigma_s, Le, g_eff) summed over regions at world points
    p_world [P, 3]. g_eff is density-weighted (single-region scenes exact)."""
    P = p_world.shape[0]
    dev = p_world.device
    sa = torch.zeros((P, S), device=dev)
    ss = torch.zeros((P, S), device=dev)
    le = torch.zeros((P, S), device=dev)
    g_num = torch.zeros((P,), device=dev)
    g_den = torch.zeros((P,), device=dev)
    for vi in range(vol.n_volumes):
        dens = _density(vol, vi, xform_point_affine(vol.w2v[vi], p_world))
        sa = sa + dens[..., None] * vol.sigma_a[vi]
        ss = ss + dens[..., None] * vol.sigma_s[vi]
        le = le + dens[..., None] * vol.le[vi]
        g_num = g_num + dens * vol.g[vi]
        g_den = g_den + dens
    return sa, ss, le, g_num / torch.clamp(g_den, min=1e-12)


def _slab(vol: VolumeT, vi: int, ray_o, ray_d, tmin, tmax):
    """Entry and exit t of region vi's box along the rays, clipped to
    [tmin, tmax]."""
    o = xform_point_affine(vol.w2v[vi], ray_o)
    inv_d = 1.0 / xform_vector(vol.w2v[vi], ray_d)
    tl = (vol.lo[vi] - o) * inv_d
    th = (vol.hi[vi] - o) * inv_d
    tn = torch.maximum(torch.amax(torch.minimum(tl, th), -1), tmin)
    tf = torch.minimum(torch.amin(torch.maximum(tl, th), -1), tmax)
    return tn, tf


def intersect_p(vol: VolumeT, ray_o, ray_d, tmin, tmax):
    """Union of region bbox spans along the ray: (hit, t0, t1). [R]-batched."""
    R = ray_o.shape[0]
    dev = ray_o.device
    t0 = torch.full((R,), float("inf"), device=dev)
    t1 = torch.full((R,), float("-inf"), device=dev)
    any_hit = torch.zeros((R,), dtype=torch.bool, device=dev)
    for vi in range(vol.n_volumes):
        tn, tf = _slab(vol, vi, ray_o, ray_d, tmin, tmax)
        hit = tn <= tf
        t0 = torch.where(hit, torch.minimum(t0, tn), t0)
        t1 = torch.where(hit, torch.maximum(t1, tf), t1)
        any_hit = any_hit | hit
    zero = torch.zeros((), device=dev)
    return any_hit, torch.where(any_hit, t0, zero), torch.where(any_hit, t1, zero)


def tau(vol: VolumeT, ray_o, ray_d, t0, t1, n_steps: int, u_offset):
    """Optical thickness along [t0, t1]. Returns [R, S].

    All-homogeneous scenes (rainbow included) get the closed form of the
    reference's HomogeneousVolumeDensity::tau (sigma_t x the clipped
    segment length); other scenes march n_steps points, the first
    jittered by u_offset [R]."""
    if all(k in (V_HOMOGENEOUS, V_RAINBOW) for k in vol.host_kind):
        acc = torch.zeros(ray_o.shape[:-1] + (S,), device=ray_o.device)
        for vi in range(vol.n_volumes):
            tn, tf = _slab(vol, vi, ray_o, ray_d, t0, t1)
            seg = torch.clamp(tf - tn, min=0.0)
            acc = acc + seg[..., None] * (vol.sigma_a[vi] + vol.sigma_s[vi])
        return acc
    dt = torch.clamp(t1 - t0, min=0.0) / n_steps
    acc = torch.zeros(ray_o.shape[:-1] + (S,), device=ray_o.device)
    for i in range(n_steps):
        t = t0 + (i + u_offset) * dt
        sa, ss, _, _ = sigma_at(vol, ray_o + t[..., None] * ray_d)
        acc = acc + (sa + ss)
    return acc * dt[..., None]


def phase(vol_g, w, wi):
    """HG phase between unit directions (g=0 -> isotropic)."""
    return phase_hg(dot(w, wi), vol_g)


# ---------------------------------------------------------------------------
# RainbowVolume transfer function (reference volumes/rainbow.cpp:41-78)

def rainbow_reflection(spectrum_in, w, wi):
    """Angle -> wavelength rainbow transfer. spectrum_in [P, S]: incident
    spectrum; w: outgoing (eye) direction, wi: incident (light)
    direction, both unit, as in the reference's rainbowReflection(L,
    ray.d, wo), with theta = angle(wi, -w). Constants from the reference:
    primary bow 40.4-42.3 deg -> 400-700 nm at 0.92; secondary 51-54.4
    deg reversed at 42% of that; a mist floor of 8%; an inner-glow ramp
    over 40.4 -> 40.45 deg."""
    cos_t = torch.clamp(dot(wi, -w), -1.0, 1.0)
    theta = torch.rad2deg(torch.arccos(cos_t))
    ramp = 1.0 - 0.1 * torch.clamp((theta - 40.4) / 0.05, 0.0, 1.0)
    intensity = phase_mie_hazy(cos_t) * ramp
    in_primary = (theta >= 40.4) & (theta <= 42.3)
    in_secondary = (theta >= 51.0) & (theta <= 54.4)
    lam_p = 400.0 + (theta - 40.4) / (42.3 - 40.4) * 300.0
    lam_s = 700.0 - (theta - 51.0) / (54.4 - 51.0) * 300.0
    lam = torch.where(in_primary, lam_p, lam_s)
    zero = torch.zeros((), device=cos_t.device)
    rainbow_i = torch.where(in_primary, torch.full((), 0.92, device=cos_t.device),
                            torch.where(in_secondary, torch.full((), 0.42 * 0.92,
                                                                 device=cos_t.device), zero))
    filtered = spec.band_filter(spectrum_in, lam)
    return intensity[..., None] * (0.08 * spectrum_in + rainbow_i[..., None] * filtered)


def has_rainbow(records: List[VolumeRecord]) -> bool:
    return any(r.kind == "rainbow" for r in records)
