"""Wavefront ray-triangle intersection over struct-of-arrays geometry.

Port of the triangle half of pbrt_tpu/accel/intersect.py. Two phases:

  phase 1 (t-pass): a running per-ray (t, prim) minimum over all
  triangles (Moller-Trumbore on precomputed v0, e1, e2). `t_pass_brute`
  is the plain block scan; the accelerators in accel/bvh.py route the
  same computation through the CUDA kernels.

  phase 2 (reconstruct): gather the winning triangle's packed row per
  ray and recompute the differential geometry (p, ng, ns, uv, dpdu).

Quadrics and motion blur are not yet ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.core.geometry import Ray

BIG = 1e30


class SceneGeom(NamedTuple):
    """Device geometry tensors; triangle t has global prim id t."""

    tri_v0: torch.Tensor      # [T, 3]
    tri_e1: torch.Tensor      # [T, 3]
    tri_e2: torch.Tensor      # [T, 3]
    tri_n: torch.Tensor       # [T, 3, 3] shading normals per vertex
    tri_has_n: torch.Tensor   # [T] bool
    tri_uv: torch.Tensor      # [T, 3, 2]
    tri_mat: torch.Tensor     # [T] int32
    tri_light: torch.Tensor   # [T] int32 (-1 = not emissive)
    world_lo: torch.Tensor    # [3]
    world_hi: torch.Tensor    # [3]
    tri_pack: torch.Tensor    # [T, 27] packed reconstruct rows

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]


class Hit(NamedTuple):
    valid: torch.Tensor   # [R] bool
    t: torch.Tensor       # [R]
    p: torch.Tensor       # [R, 3]
    ng: torch.Tensor      # [R, 3] geometric normal (winding-oriented)
    ns: torch.Tensor      # [R, 3] shading normal
    uv: torch.Tensor      # [R, 2]
    dpdu: torch.Tensor    # [R, 3]
    mat: torch.Tensor     # [R] int64 (-1 none)
    light: torch.Tensor   # [R] int64 (-1 none)
    prim: torch.Tensor    # [R] int64 global prim id (-1 none)


# ---------------------------------------------------------------------------
# Moller-Trumbore, componentwise in the reference kernels' operation order

def mt_t(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy, dz, tmin, tmax):
    """Candidate distance and validity; all arguments broadcast."""
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok_det = torch.abs(det) > 1e-12
    inv_det = torch.where(ok_det, 1.0 / det, torch.zeros((), device=det.device))
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    valid = (ok_det & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
             & (t > tmin) & (t < tmax))
    return t, valid


def t_pass_brute(geom: SceneGeom, ray: Ray, block: int = 512):
    """[R] rays vs all triangles. Returns (t [R], prim [R] int64)."""
    R = ray.o.shape[0]
    dev = ray.o.device
    big = torch.full((), BIG, device=dev)
    t_best = torch.where(torch.isfinite(ray.tmax), ray.tmax, big)
    prim_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    o = [ray.o[:, i:i + 1] for i in range(3)]
    d = [ray.d[:, i:i + 1] for i in range(3)]
    for s in range(0, geom.n_tris, block):
        v0 = geom.tri_v0[s:s + block]
        e1 = geom.tri_e1[s:s + block]
        e2 = geom.tri_e2[s:s + block]
        tris = [x[None, :, i] for x in (v0, e1, e2) for i in range(3)]
        t, valid = mt_t(*tris, *o, *d, ray.tmin[:, None], t_best[:, None])
        t = torch.where(valid, t, big)
        tmin_blk, idx = torch.min(t, -1)
        better = tmin_blk < t_best
        t_best = torch.where(better, tmin_blk, t_best)
        prim_best = torch.where(better, s + idx, prim_best)
    return torch.where(prim_best >= 0, t_best, big), prim_best


# ---------------------------------------------------------------------------
# Packed reconstruct: one row gather per hit

def make_tri_pack(v0, e1, e2, n, uv, has_n, mat, light):
    """Host build of the [T, 27] triangle reconstruct rows:
      0-8   v0 e1 e2
      9-17  shading normals n0 n1 n2
      18-23 uv0 uv1 uv2
      24    has_n (0/1)   25 mat   26 light   (ints exact in f32)"""
    T = len(v0)
    if T == 0:
        return np.zeros((0, 27), np.float32)
    cols = [
        np.asarray(v0, np.float32), np.asarray(e1, np.float32),
        np.asarray(e2, np.float32),
        np.asarray(n, np.float32).reshape(T, 9),
        np.asarray(uv, np.float32).reshape(T, 6),
        np.asarray(has_n, np.float32).reshape(T, 1),
        np.asarray(mat, np.float32).reshape(T, 1),
        np.asarray(light, np.float32).reshape(T, 1),
    ]
    return np.concatenate(cols, axis=1)


def _rsqrt_norm3(x, y, z):
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-24))
    return x * inv, y * inv, z * inv


def _coord_sys_c(nx, ny, nz):
    """coordinate_system first axis, componentwise."""
    use_x = torch.abs(nx) > torch.abs(ny)
    inv1 = torch.rsqrt(torch.clamp(nx * nx + nz * nz, min=1e-24))
    inv2 = torch.rsqrt(torch.clamp(ny * ny + nz * nz, min=1e-24))
    zero = torch.zeros((), device=nx.device)
    v1x = torch.where(use_x, -nz * inv1, zero)
    v1y = torch.where(use_x, zero, nz * inv2)
    v1z = torch.where(use_x, nx * inv1, -ny * inv2)
    return v1x, v1y, v1z


def reconstruct(geom: SceneGeom, ray: Ray, t, prim) -> Hit:
    """Phase 2: differential geometry for the winning triangle per ray
    (pbrt_tpu accel/intersect.py _reconstruct_packed, triangle half)."""
    T = geom.n_tris
    dev = ray.o.device
    valid = prim >= 0
    ox, oy, oz = ray.o[:, 0], ray.o[:, 1], ray.o[:, 2]
    dx, dy, dz = ray.d[:, 0], ray.d[:, 1], ray.d[:, 2]
    zero = torch.zeros((), device=dev)

    tri_idx = torch.clamp(torch.where(valid, prim, 0), 0, max(T - 1, 0))
    P = geom.tri_pack[tri_idx]                    # [N, 27] one gather

    def c(i):
        return P[:, i]

    e1x, e1y, e1z = c(3), c(4), c(5)
    e2x, e2y, e2z = c(6), c(7), c(8)
    # geometric normal
    ngx = e1y * e2z - e1z * e2y
    ngy = e1z * e2x - e1x * e2z
    ngz = e1x * e2y - e1y * e2x
    ngx, ngy, ngz = _rsqrt_norm3(ngx, ngy, ngz)
    # Moller-Trumbore barycentrics at the hit
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = torch.where(torch.abs(det) > 1e-12, 1.0 / det, zero)
    tvx, tvy, tvz = ox - c(0), oy - c(1), oz - c(2)
    b1 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    b2 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    b0 = 1.0 - b1 - b2
    # shading normal blend
    nsx = b0 * c(9) + b1 * c(12) + b2 * c(15)
    nsy = b0 * c(10) + b1 * c(13) + b2 * c(16)
    nsz = b0 * c(11) + b1 * c(14) + b2 * c(17)
    nsx, nsy, nsz = _rsqrt_norm3(nsx, nsy, nsz)
    has_n = c(24) > 0.5
    nsx = torch.where(has_n, nsx, ngx)
    nsy = torch.where(has_n, nsy, ngy)
    nsz = torch.where(has_n, nsz, ngz)
    # uv blend
    u_t = b0 * c(18) + b1 * c(20) + b2 * c(22)
    v_t = b0 * c(19) + b1 * c(21) + b2 * c(23)
    # dpdu from the uv parameterization
    du1u, du1v = c(20) - c(18), c(21) - c(19)
    du2u, du2v = c(22) - c(18), c(23) - c(19)
    det_uv = du1u * du2v - du1v * du2u
    inv_uv = torch.where(torch.abs(det_uv) > 1e-12, 1.0 / det_uv, zero)
    dpdux = (du2v * e1x - du1v * e2x) * inv_uv
    dpduy = (du2v * e1y - du1v * e2y) * inv_uv
    dpduz = (du2v * e1z - du1v * e2z) * inv_uv
    fbx, fby, fbz = _coord_sys_c(ngx, ngy, ngz)
    degen = torch.abs(det_uv) < 1e-12
    dpdux = torch.where(degen, fbx, dpdux)
    dpduy = torch.where(degen, fby, dpduy)
    dpduz = torch.where(degen, fbz, dpduz)
    mat = c(25).to(torch.int64)
    light = c(26).to(torch.int64)

    hx = ox + t * dx
    hy = oy + t * dy
    hz = oz + t * dz
    # keep ng in the ns hemisphere (trianglemesh convention)
    flip_ng = ngx * nsx + ngy * nsy + ngz * nsz < 0.0
    fs = torch.where(flip_ng, torch.full((), -1.0, device=dev), torch.ones((), device=dev))
    ngx, ngy, ngz = fs * ngx, fs * ngy, fs * ngz

    def msk(x):
        return torch.where(valid, x, zero)  # where, not multiply: NaN-safe

    return Hit(
        valid=valid,
        t=torch.where(valid, t, torch.full((), BIG, device=dev)),
        p=torch.stack([msk(hx), msk(hy), msk(hz)], -1),
        ng=torch.stack([msk(ngx), msk(ngy), msk(ngz)], -1),
        ns=torch.stack([msk(nsx), msk(nsy), msk(nsz)], -1),
        uv=torch.stack([msk(u_t), msk(v_t)], -1),
        dpdu=torch.stack([msk(dpdux), msk(dpduy), msk(dpduz)], -1),
        mat=torch.where(valid, mat, -1),
        light=torch.where(valid, light, -1),
        prim=torch.where(valid, prim, -1),
    )
