"""Wavefront ray-scene intersection over struct-of-arrays geometry.

Port of pbrt_tpu/accel/intersect.py. Two phases:

  phase 1 (t-pass): a running per-ray (t, prim) minimum over all
  triangles (Moller-Trumbore on precomputed v0, e1, e2) and quadrics.
  `t_pass_brute` is the plain triangle block scan; the accelerators in
  accel/bvh.py route the triangles through the CUDA kernels (static
  scenes), the block scan or the binary-BVH walk, and then fold the
  (few) quadrics in with `quad_t_pass`: quadric q has global prim id
  n_tris + q.

  phase 2 (reconstruct): gather the winning primitive's packed row per
  ray and recompute the differential geometry (p, ng, ns, uv, dpdu).

`intersect` / `intersect_p` run both phases by exhaustion (t_pass_all),
as the reference's free functions of the same names do.

Quadrics (sphere/cylinder/disk/cone/paraboloid/hyperboloid) are solved
analytically in object space with pbrt's partial ranges (zmin/zmax/
phimax, disk innerradius), both roots checked (reference
shapes/sphere.cpp:219 et al.).

Motion blur (two-keyframe linear motion, reference core/primitive.h
:115-117 TransformedPrimitive + AnimatedTransform): an animated scene
carries per-triangle vertex deltas, so v(t) = v + t * dv with t the
shutter-normalized ray time, and each quadric's end-of-shutter
transforms, interpolated as raw matrices (not slerped), as the JAX
package does. The packed reconstruct rows then carry the motion
columns too (tri_pack 36 wide instead of 27, quad_pack 58 instead of
34).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core.geometry import Ray, normalize
from pbrt_tpu_torch.core.transform import xform_normal, xform_point_affine, xform_vector
from pbrt_tpu_torch.shapes.registry import (
    QUAD_CONE,
    QUAD_CYLINDER,
    QUAD_DISK,
    QUAD_HYPERBOLOID,
    QUAD_PARABOLOID,
    QUAD_SPHERE,
)

BIG = 1e30


class SceneGeom(NamedTuple):
    """Device geometry tensors. Triangles occupy global prim ids [0, T);
    quadric q has global id T + q. The quadric fields are None in
    triangle-only geometries built by hand."""

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
    quad_type: torch.Tensor = None    # [Q] int32
    quad_o2w: torch.Tensor = None     # [Q, 4, 4]
    quad_w2o: torch.Tensor = None     # [Q, 4, 4]
    quad_params: torch.Tensor = None  # [Q, 8]
    quad_mat: torch.Tensor = None     # [Q] int32
    quad_light: torch.Tensor = None   # [Q] int32
    quad_flip: torch.Tensor = None    # [Q] bool: flip normals (reverseorientation ^ swap)
    quad_pack: torch.Tensor = None    # [Q, 34] packed reconstruct rows
    # the quadric types present, kept on the host (None = any): the
    # t-pass elides the branches of absent types without a device read
    quad_present: frozenset = None
    # motion blur: vertex deltas (v(t) = v + t dv, t in [0, 1] over the
    # shutter) and the quadrics' end-of-shutter transforms (with
    # host-computed inverses); None in static scenes
    tri_dv0: torch.Tensor = None      # [T, 3]
    tri_de1: torch.Tensor = None      # [T, 3]
    tri_de2: torch.Tensor = None      # [T, 3]
    quad_o2w_end: torch.Tensor = None  # [Q, 4, 4]
    quad_w2o_end: torch.Tensor = None  # [Q, 4, 4]
    time0: float = 0.0                 # shutter open (transform keyframe times)
    time1: float = 1.0                 # shutter close

    @property
    def n_tris(self):
        return self.tri_v0.shape[0]

    @property
    def n_quads(self):
        return 0 if self.quad_type is None else self.quad_type.shape[0]

    @property
    def has_motion(self):
        return self.tri_dv0 is not None or self.quad_o2w_end is not None

    def norm_time(self, time):
        """Ray time -> [0, 1] keyframe interpolant."""
        span = max(self.time1 - self.time0, 1e-9)
        return torch.clamp((time - self.time0) / span, 0.0, 1.0)

    def tri_at(self, idx, time):
        """Triangle (v0, e1, e2) at ray time; idx/time broadcastable."""
        v0, e1, e2 = self.tri_v0[idx], self.tri_e1[idx], self.tri_e2[idx]
        if self.tri_dv0 is None:
            return v0, e1, e2
        dt = self.norm_time(time)[..., None]
        return (v0 + dt * self.tri_dv0[idx], e1 + dt * self.tri_de1[idx],
                e2 + dt * self.tri_de2[idx])

    def quad_xforms_at(self, idx, time):
        """(o2w, w2o) of quadrics idx at ray time: a linear blend of the
        keyframe matrices (endpoints exact, no per-ray inversion)."""
        o2w = self.quad_o2w[idx]
        if self.quad_o2w_end is None:
            return o2w, self.quad_w2o[idx]
        dt = self.norm_time(time)[..., None, None]
        return ((1.0 - dt) * o2w + dt * self.quad_o2w_end[idx],
                (1.0 - dt) * self.quad_w2o[idx] + dt * self.quad_w2o_end[idx])


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
    """[R] rays vs all triangles (at each ray's time in a motion scene).
    Returns (t [R], prim [R] int64). The result does not depend on the
    block size: the least t, the lowest index on ties."""
    R = ray.o.shape[0]
    dev = ray.o.device
    big = torch.full((), BIG, device=dev)
    t_best = torch.where(torch.isfinite(ray.tmax), ray.tmax, big)
    prim_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    o = [ray.o[:, i:i + 1] for i in range(3)]
    d = [ray.d[:, i:i + 1] for i in range(3)]
    moving = geom.tri_dv0 is not None
    if moving:
        # per-ray vertices: bound the [R, block] temporaries
        block = max(32, min(block, (1 << 22) // max(R, 1)))
        dt = geom.norm_time(ray.time)[:, None]
    for s in range(0, geom.n_tris, block):
        sl = slice(s, s + block)
        v0, e1, e2 = geom.tri_v0[sl], geom.tri_e1[sl], geom.tri_e2[sl]
        tris = [x[None, :, i] for x in (v0, e1, e2) for i in range(3)]
        if moving:
            deltas = [x[None, :, i] for x in (geom.tri_dv0[sl], geom.tri_de1[sl],
                                              geom.tri_de2[sl]) for i in range(3)]
            tris = [a + dt * b for a, b in zip(tris, deltas)]
        t, valid = mt_t(*tris, *o, *d, ray.tmin[:, None], t_best[:, None])
        t = torch.where(valid, t, big)
        tmin_blk = torch.amin(t, -1)
        cols = torch.arange(t.shape[1], device=dev)
        idx = torch.amin(torch.where(t == tmin_blk[:, None], cols, t.shape[1]), -1)
        better = tmin_blk < t_best
        t_best = torch.where(better, tmin_blk, t_best)
        prim_best = torch.where(better, s + idx, prim_best)
    return torch.where(prim_best >= 0, t_best, big), prim_best


def t_pass_all(geom: SceneGeom, ray: Ray):
    """Every primitive by exhaustion: the triangles' block scan, then
    the quadric fold (what the JAX package's t_pass_brute computes).
    Returns (t [R], prim [R] int64)."""
    t, prim = t_pass_brute(geom, ray)
    if geom.n_quads > 0:
        t, prim = quad_t_pass(geom, ray, t, prim)
    return t, prim


# ---------------------------------------------------------------------------
# Quadrics: candidate t (object space, both roots, range-clipped)

def quad_candidates(qtype, params, o, d, tmin, tmax, present=None):
    """All-types quadric intersection. Shapes broadcast: qtype [...],
    params [..., 8], o/d [..., 3] (already object space). Returns (t, valid).

    present: optional host set of the quadric type ids in the scene; the
    terms of absent types are left out (they would add exact zeros)."""
    r, zmin, zmax, phimax, p4, p5 = (params[..., i] for i in range(6))
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    dev = ox.device
    zero = torch.zeros((), device=dev)

    def has(k):
        return present is None or k in present

    false = torch.zeros(ox.shape, dtype=torch.bool, device=dev)
    is_sph, is_cyl, is_disk, is_cone, is_par, is_hyp = (
        (qtype == k) if has(k) else false
        for k in (QUAD_SPHERE, QUAD_CYLINDER, QUAD_DISK, QUAD_CONE, QUAD_PARABOLOID,
                  QUAD_HYPERBOLOID))

    # quadratic coefficients per type
    kc = r / torch.clamp(p4, min=1e-12)                # p4 = height
    k_cone = kc * kc
    k_par = p4 / torch.clamp(r * r, min=1e-12)         # p4 = zmax
    a_h, c_h = p4, p5
    terms = []                                         # (mask, A, B, C)
    if has(QUAD_SPHERE):
        terms.append((is_sph, lambda: dx * dx + dy * dy + dz * dz,
                      lambda: 2.0 * (ox * dx + oy * dy + oz * dz),
                      lambda: ox * ox + oy * oy + oz * oz - r * r))
    if has(QUAD_CYLINDER):
        terms.append((is_cyl, lambda: dx * dx + dy * dy, lambda: 2.0 * (ox * dx + oy * dy),
                      lambda: ox * ox + oy * oy - r * r))
    if has(QUAD_CONE):
        terms.append((is_cone, lambda: dx * dx + dy * dy - k_cone * dz * dz,
                      lambda: 2.0 * (ox * dx + oy * dy - k_cone * dz * (oz - p4)),
                      lambda: ox * ox + oy * oy - k_cone * (oz - p4) * (oz - p4)))
    if has(QUAD_PARABOLOID):
        terms.append((is_par, lambda: k_par * (dx * dx + dy * dy),
                      lambda: 2.0 * k_par * (ox * dx + oy * dy) - dz,
                      lambda: k_par * (ox * ox + oy * oy) - oz))
    if has(QUAD_HYPERBOLOID):
        terms.append((is_hyp, lambda: a_h * (dx * dx + dy * dy) - c_h * dz * dz,
                      lambda: 2.0 * (a_h * (ox * dx + oy * dy) - c_h * oz * dz),
                      lambda: a_h * (ox * ox + oy * oy) - c_h * oz * oz - 1.0))
    coef = []
    for j in (1, 2, 3):
        acc = torch.zeros(ox.shape, device=dev)
        for term in terms:
            acc = acc + torch.where(term[0], term[j](), zero)
        coef.append(acc)
    A, B, C = coef

    disc = B * B - 4.0 * A * C
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    # numerically stable roots; sign(0) must be +1, not 0: a ray from the
    # quadric's center has B == 0
    sgn_b = torch.where(B >= 0.0, 1.0, -1.0)
    qq = -0.5 * (B + sgn_b * sq)
    one = torch.ones((), device=dev)
    safe_a = torch.where(torch.abs(A) > 1e-12, A, one)
    safe_q = torch.where(torch.abs(qq) > 1e-12, qq, one)
    t0r = qq / safe_a
    t1r = C / safe_q
    lin_ok = torch.abs(A) <= 1e-12
    # linear case (paraboloid with dz dominant etc.): Bt + C = 0
    t_lin = -C / torch.where(torch.abs(B) > 1e-12, B, one)
    t0 = torch.where(lin_ok, t_lin, torch.minimum(t0r, t1r))
    t1 = torch.where(lin_ok, t_lin, torch.maximum(t0r, t1r))
    quad_ok = torch.where(lin_ok, torch.abs(B) > 1e-12, disc >= 0.0)

    # disk: plane z = height (the zmin slot)
    t_disk = (zmin - oz) / torch.where(torch.abs(dz) > 1e-12, dz, one)
    disk_ok = torch.abs(dz) > 1e-12

    def clip(t):
        x, yv, z = ox + t * dx, oy + t * dy, oz + t * dz
        phi = torch.atan2(yv, x)
        phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
        in_phi = phi <= phimax + 1e-7
        in_z = (z >= zmin) & (z <= zmax)
        dist2 = x * x + yv * yv
        in_disk = (dist2 <= r * r) & (dist2 >= p4 * p4)  # p4 = innerradius
        ok = torch.where(is_disk, in_disk & in_phi, in_z & in_phi)
        return ok & (t > tmin) & (t < tmax)

    big = torch.full((), BIG, device=dev)
    tq = torch.where(is_disk, t_disk, t0)
    ok0 = torch.where(is_disk, disk_ok, quad_ok) & clip(tq)
    tq2 = torch.where(is_disk, big, t1)
    ok1 = ~is_disk & quad_ok & clip(tq2)
    t = torch.where(ok0, tq, torch.where(ok1, tq2, big))
    return t, ok0 | ok1


@probes.spanned("accel/quad")
def quad_t_pass(geom: SceneGeom, ray: Ray, t_best, prim_best):
    """Fold the quadrics into an existing (t, prim) accumulator (a
    triangle t-pass's result; prim -1 = no hit so far). A quadric must
    be strictly nearer to win, so a triangle keeps a tie; among quadrics
    at equal t the lowest index wins. Returns (t, prim int64). One
    `accel/quad` span a call while tracing is on."""
    T = geom.n_tris
    dev = ray.o.device
    big = torch.full((), BIG, device=dev)
    t_best = torch.where(prim_best >= 0, t_best,
                         torch.where(torch.isfinite(ray.tmax), ray.tmax, big))
    if geom.quad_o2w_end is not None:   # [R, Q, 4, 4] at each ray's time
        _, w2o = geom.quad_xforms_at(torch.arange(geom.n_quads, device=dev)[None, :],
                                     ray.time[:, None])
    else:
        w2o = geom.quad_w2o[None]
    o_obj = xform_point_affine(w2o, ray.o[:, None])   # [R, Q, 3]
    d_obj = xform_vector(w2o, ray.d[:, None])
    t, valid = quad_candidates(geom.quad_type[None], geom.quad_params[None], o_obj, d_obj,
                               ray.tmin[:, None], t_best[:, None], present=geom.quad_present)
    t = torch.where(valid, t, big)
    tmin_q = torch.amin(t, -1)
    Q = t.shape[-1]
    cols = torch.arange(Q, device=dev)
    idx = torch.amin(torch.where(t == tmin_q[:, None], cols, Q), -1)
    better = tmin_q < t_best
    t_out = torch.where(better, tmin_q, t_best)
    prim_out = torch.where(better, T + idx, prim_best.long())
    return torch.where(prim_out >= 0, t_out, big), prim_out


def quad_detail(qtype, params, flip, o2w, w2o, ray_o, ray_d, t):
    """Differential geometry at the object-space hit of one quadric per
    ray from the per-field tables, all inputs gathered per ray -> (p,
    n, uv, dpdu) in world space. The reconstruct of hand-built
    geometries without a quad_pack."""
    o = xform_point_affine(w2o, ray_o)
    d = xform_vector(w2o, ray_d)
    ph = o + t[..., None] * d
    x, yv, z = ph[..., 0], ph[..., 1], ph[..., 2]
    r, zmin, zmax, phimax, p4, p5 = (params[..., i] for i in range(6))
    phi = torch.atan2(yv, x)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    is_sph, is_cyl, is_disk, is_cone, is_par = (
        qtype == k for k in (QUAD_SPHERE, QUAD_CYLINDER, QUAD_DISK, QUAD_CONE,
                             QUAD_PARABOLOID))

    u = phi / torch.clamp(phimax, min=1e-9)
    rr = torch.clamp(r, min=1e-12)
    theta = torch.arccos(torch.clamp(z / rr, -1.0, 1.0))
    thmin = torch.arccos(torch.clamp(zmax / rr, -1.0, 1.0))
    thmax = torch.arccos(torch.clamp(zmin / rr, -1.0, 1.0))
    v_sph = (theta - thmin) / torch.clamp(thmax - thmin, min=1e-9)
    v_lin = (z - zmin) / torch.clamp(zmax - zmin, min=1e-9)
    dist = torch.sqrt(torch.clamp(x * x + yv * yv, min=1e-20))
    v_disk = 1.0 - (dist - p4) / torch.clamp(r - p4, min=1e-9)
    v = torch.where(is_sph, v_sph, torch.where(is_disk, v_disk, v_lin))

    zero, one = torch.zeros_like(x), torch.ones_like(x)
    dpdu = torch.stack([-phimax * yv, phimax * x, zero], -1)
    kc = r / torch.clamp(p4, min=1e-12)
    k_cone = kc * kc
    k_par = p4 / torch.clamp(r * r, min=1e-12)
    n_obj = torch.where(
        is_sph[..., None], ph,
        torch.where(is_cyl[..., None], torch.stack([x, yv, zero], -1),
                    torch.where(is_disk[..., None], torch.stack([zero, zero, one], -1),
                                torch.where(is_cone[..., None],
                                            torch.stack([x, yv, -k_cone * (z - p4)], -1),
                                            torch.where(is_par[..., None],
                                                        torch.stack([2.0 * k_par * x,
                                                                     2.0 * k_par * yv, -one], -1),
                                                        torch.stack([2.0 * p4 * x, 2.0 * p4 * yv,
                                                                     -2.0 * p5 * z], -1))))))
    p_world = xform_point_affine(o2w, ph)
    n_world = normalize(xform_normal(w2o, n_obj))
    n_world = torch.where(flip[..., None], -n_world, n_world)
    return p_world, n_world, torch.stack([u, v], -1), xform_vector(o2w, dpdu)


# ---------------------------------------------------------------------------
# Packed reconstruct: one row gather per hit

def make_tri_pack(v0, e1, e2, n, uv, has_n, mat, light, dv0=None, de1=None, de2=None):
    """Host build of the [T, 27 (+9)] triangle reconstruct rows:
      0-8   v0 e1 e2
      9-17  shading normals n0 n1 n2
      18-23 uv0 uv1 uv2
      24    has_n (0/1)   25 mat   26 light   (ints exact in f32)
      27-35 motion deltas dv0 de1 de2 (present iff animated)"""
    T = len(v0)
    if T == 0:
        return np.zeros((0, 36 if dv0 is not None else 27), np.float32)
    cols = [
        np.asarray(v0, np.float32), np.asarray(e1, np.float32),
        np.asarray(e2, np.float32),
        np.asarray(n, np.float32).reshape(T, 9),
        np.asarray(uv, np.float32).reshape(T, 6),
        np.asarray(has_n, np.float32).reshape(T, 1),
        np.asarray(mat, np.float32).reshape(T, 1),
        np.asarray(light, np.float32).reshape(T, 1),
    ]
    if dv0 is not None:
        cols += [np.asarray(x, np.float32) for x in (dv0, de1, de2)]
    return np.concatenate(cols, axis=1)


def make_quad_pack(o2w, w2o, params, qtype, flip, mat, light, o2w_end=None, w2o_end=None):
    """Host build of the [Q, 34 (+24)] quadric reconstruct rows:
      0-11  o2w affine rows (3x4, row-major)
      12-23 w2o affine rows
      24-29 params r zmin zmax phimax p4 p5
      30 type  31 flip  32 mat  33 light
      34-45 o2w_end affine, 46-57 w2o_end affine (iff animated)"""
    Q = len(qtype)
    if Q == 0:
        return np.zeros((0, 58 if o2w_end is not None else 34), np.float32)
    cols = [
        np.asarray(o2w, np.float32)[:, :3, :4].reshape(Q, 12),
        np.asarray(w2o, np.float32)[:, :3, :4].reshape(Q, 12),
        np.asarray(params, np.float32)[:, :6],
        np.asarray(qtype, np.float32).reshape(Q, 1),
        np.asarray(flip, np.float32).reshape(Q, 1),
        np.asarray(mat, np.float32).reshape(Q, 1),
        np.asarray(light, np.float32).reshape(Q, 1),
    ]
    if o2w_end is not None:
        cols += [np.asarray(o2w_end, np.float32)[:, :3, :4].reshape(Q, 12),
                 np.asarray(w2o_end, np.float32)[:, :3, :4].reshape(Q, 12)]
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


def _tri_detail(geom: SceneGeom, ray: Ray, prim, is_tri):
    """Triangle half of the reconstruct: one row gather of tri_pack ->
    (ng, ns, dpdu, (u, v), mat, light), componentwise."""
    T = geom.n_tris
    ox, oy, oz = ray.o[:, 0], ray.o[:, 1], ray.o[:, 2]
    dx, dy, dz = ray.d[:, 0], ray.d[:, 1], ray.d[:, 2]
    zero = torch.zeros((), device=ray.o.device)
    P = geom.tri_pack[torch.clamp(torch.where(is_tri, prim, 0), 0, T - 1)]  # one gather

    def c(i):
        return P[:, i]

    v0x, v0y, v0z = c(0), c(1), c(2)
    e1x, e1y, e1z = c(3), c(4), c(5)
    e2x, e2y, e2z = c(6), c(7), c(8)
    if P.shape[1] >= 36:                             # motion deltas
        dt = geom.norm_time(ray.time)
        v0x, v0y, v0z = v0x + dt * c(27), v0y + dt * c(28), v0z + dt * c(29)
        e1x, e1y, e1z = e1x + dt * c(30), e1y + dt * c(31), e1z + dt * c(32)
        e2x, e2y, e2z = e2x + dt * c(33), e2y + dt * c(34), e2z + dt * c(35)
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
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
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
    return ((ngx, ngy, ngz), (nsx, nsy, nsz), (dpdux, dpduy, dpduz), (u_t, v_t),
            c(25).to(torch.int64), c(26).to(torch.int64))


def _quad_detail_packed(geom: SceneGeom, ray: Ray, t, quad_idx):
    """Quadric half of the reconstruct: one row gather of quad_pack ->
    (p, n, dpdu, (u, v), mat, light) in world space, componentwise."""
    ox, oy, oz = ray.o[:, 0], ray.o[:, 1], ray.o[:, 2]
    dx, dy, dz = ray.d[:, 0], ray.d[:, 1], ray.d[:, 2]
    QP = geom.quad_pack[quad_idx]                    # [N, 34 (58)] one gather

    def m(i):
        return QP[:, i]

    if QP.shape[1] >= 58:                            # animated transforms
        dt = geom.norm_time(ray.time)

        def a_(i):
            return (1.0 - dt) * QP[:, i] + dt * QP[:, 34 + i]

        def b_(i):
            return (1.0 - dt) * QP[:, 12 + i] + dt * QP[:, 46 + i]
    else:
        def a_(i):
            return QP[:, i]

        def b_(i):
            return QP[:, 12 + i]

    # object-space ray and hit
    o_qx = b_(0) * ox + b_(1) * oy + b_(2) * oz + b_(3)
    o_qy = b_(4) * ox + b_(5) * oy + b_(6) * oz + b_(7)
    o_qz = b_(8) * ox + b_(9) * oy + b_(10) * oz + b_(11)
    d_qx = b_(0) * dx + b_(1) * dy + b_(2) * dz
    d_qy = b_(4) * dx + b_(5) * dy + b_(6) * dz
    d_qz = b_(8) * dx + b_(9) * dy + b_(10) * dz
    px = o_qx + t * d_qx
    py = o_qy + t * d_qy
    pz = o_qz + t * d_qz
    r_ = m(24)
    zmin, zmax = m(25), m(26)
    phimax = m(27)
    p4, p5 = m(28), m(29)
    qtype = m(30).to(torch.int64)
    flip = m(31) > 0.5

    phi = torch.atan2(py, px)
    phi = torch.where(phi < 0.0, phi + 2.0 * math.pi, phi)
    is_sph, is_cyl, is_disk, is_cone, is_par = (
        qtype == k for k in (QUAD_SPHERE, QUAD_CYLINDER, QUAD_DISK, QUAD_CONE,
                             QUAD_PARABOLOID))

    u_q = phi / torch.clamp(phimax, min=1e-9)
    rr = torch.clamp(r_, min=1e-12)
    theta = torch.arccos(torch.clamp(pz / rr, -1.0, 1.0))
    thmin = torch.arccos(torch.clamp(zmax / rr, -1.0, 1.0))
    thmax = torch.arccos(torch.clamp(zmin / rr, -1.0, 1.0))
    v_sph = (theta - thmin) / torch.clamp(thmax - thmin, min=1e-9)
    v_lin = (pz - zmin) / torch.clamp(zmax - zmin, min=1e-9)
    dist = torch.sqrt(torch.clamp(px * px + py * py, min=1e-20))
    v_disk = 1.0 - (dist - p4) / torch.clamp(r_ - p4, min=1e-9)
    v_q = torch.where(is_sph, v_sph, torch.where(is_disk, v_disk, v_lin))

    # object-space dpdu (rotation about z) and normal per type
    dpqx, dpqy, dpqz = -phimax * py, phimax * px, torch.zeros_like(px)
    kc = r_ / torch.clamp(p4, min=1e-12)
    k_cone = kc * kc
    k_par = p4 / torch.clamp(r_ * r_, min=1e-12)
    zero, one = torch.zeros((), device=px.device), torch.ones((), device=px.device)
    n_ox = torch.where(is_sph | is_cyl | is_cone, px, torch.where(
        is_disk, zero, torch.where(is_par, 2.0 * k_par * px, 2.0 * p4 * px)))
    n_oy = torch.where(is_sph | is_cyl | is_cone, py, torch.where(
        is_disk, zero, torch.where(is_par, 2.0 * k_par * py, 2.0 * p4 * py)))
    n_oz = torch.where(is_sph, pz, torch.where(is_cyl, zero, torch.where(
        is_disk, one, torch.where(is_cone, -k_cone * (pz - p4),
                                  torch.where(is_par, -one, -2.0 * p5 * pz)))))

    # world-space position (o2w point), normal (w2o^T), dpdu (o2w vector)
    p_q = (a_(0) * px + a_(1) * py + a_(2) * pz + a_(3),
           a_(4) * px + a_(5) * py + a_(6) * pz + a_(7),
           a_(8) * px + a_(9) * py + a_(10) * pz + a_(11))
    n_qx, n_qy, n_qz = _rsqrt_norm3(b_(0) * n_ox + b_(4) * n_oy + b_(8) * n_oz,
                                    b_(1) * n_ox + b_(5) * n_oy + b_(9) * n_oz,
                                    b_(2) * n_ox + b_(6) * n_oy + b_(10) * n_oz)
    sgn = torch.where(flip, -one, one)
    dq = (a_(0) * dpqx + a_(1) * dpqy + a_(2) * dpqz,
          a_(4) * dpqx + a_(5) * dpqy + a_(6) * dpqz,
          a_(8) * dpqx + a_(9) * dpqy + a_(10) * dpqz)
    return (p_q, (sgn * n_qx, sgn * n_qy, sgn * n_qz), dq, (u_q, v_q),
            m(32).to(torch.int64), m(33).to(torch.int64))


def _quad_detail_fields(geom: SceneGeom, ray: Ray, t, quad_idx):
    """quad_detail over the per-field tables, split like _quad_detail_packed."""
    o2w, w2o = geom.quad_xforms_at(quad_idx, ray.time)
    p, n, uv, dpdu = quad_detail(geom.quad_type[quad_idx], geom.quad_params[quad_idx],
                                 geom.quad_flip[quad_idx], o2w, w2o, ray.o, ray.d, t)
    return (p.unbind(-1), n.unbind(-1), dpdu.unbind(-1), uv.unbind(-1),
            geom.quad_mat[quad_idx].long(), geom.quad_light[quad_idx].long())


def reconstruct(geom: SceneGeom, ray: Ray, t, prim) -> Hit:
    """Phase 2: differential geometry for the winning prim per ray
    (pbrt_tpu accel/intersect.py _reconstruct_packed). All math runs on
    split [N] components and stacks into the [N, 3] Hit fields once."""
    T, Q = geom.n_tris, geom.n_quads
    dev = ray.o.device
    R = ray.o.shape[0]
    valid = prim >= 0
    is_tri = valid & (prim < T)
    zf = torch.zeros((R,), device=dev)
    zi = torch.zeros((R,), dtype=torch.int64, device=dev)
    zero = torch.zeros((), device=dev)

    if T > 0:
        ng_t, ns_t, dpdu_t, uv_t, mat_t, light_t = _tri_detail(geom, ray, prim, is_tri)
    else:
        ng_t = ns_t = dpdu_t = (zf, zf, zf)
        uv_t = (zf, zf)
        mat_t = light_t = zi
    if Q > 0:
        quad_idx = torch.clamp(torch.where(valid & ~is_tri, prim - T, 0), 0, Q - 1)
        detail = _quad_detail_packed if geom.quad_pack is not None else _quad_detail_fields
        p_q, n_q, dpdu_q, uv_q, mat_q, light_q = detail(geom, ray, t, quad_idx)
    else:
        p_q = n_q = dpdu_q = (zf, zf, zf)
        uv_q = (zf, zf)
        mat_q = light_q = zi

    # merge triangle/quadric lanes componentwise
    def sel(a, b):
        return [torch.where(is_tri, x, y) for x, y in zip(a, b)]

    hit_p = (ray.o[:, 0] + t * ray.d[:, 0], ray.o[:, 1] + t * ray.d[:, 1],
             ray.o[:, 2] + t * ray.d[:, 2])
    p = sel(hit_p, p_q)
    ng = sel(ng_t, n_q)
    ns = sel(ns_t, n_q)
    dpdu = sel(dpdu_t, dpdu_q)
    uv = sel(uv_t, uv_q)
    mat = torch.where(is_tri, mat_t, mat_q)
    light = torch.where(is_tri, light_t, light_q)
    # keep ng in the ns hemisphere (trianglemesh convention)
    flip_ng = ng[0] * ns[0] + ng[1] * ns[1] + ng[2] * ns[2] < 0.0
    fs = torch.where(flip_ng, torch.full((), -1.0, device=dev), torch.ones((), device=dev))
    ng = [fs * x for x in ng]

    def msk(xs):
        return torch.stack([torch.where(valid, x, zero) for x in xs], -1)  # NaN-safe

    return Hit(
        valid=valid,
        t=torch.where(valid, t, torch.full((), BIG, device=dev)),
        p=msk(p), ng=msk(ng), ns=msk(ns), uv=msk(uv), dpdu=msk(dpdu),
        mat=torch.where(valid, mat, -1),
        light=torch.where(valid, light, -1),
        prim=torch.where(valid, prim, -1),
    )


def intersect(geom: SceneGeom, ray: Ray) -> Hit:
    """Closest hit by exhaustion (t_pass_all, then reconstruct)."""
    t, prim = t_pass_all(geom, ray)
    return reconstruct(geom, ray, t, prim)


def intersect_p(geom: SceneGeom, ray: Ray) -> torch.Tensor:
    """Occlusion query: any hit in (tmin, tmax)? -> [R] bool."""
    _, prim = t_pass_all(geom, ray)
    return prim >= 0
