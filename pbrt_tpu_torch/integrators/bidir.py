"""Bidirectional path evaluation for Metropolis light transport.

Port of pbrt_tpu/integrators/bidir.py (reference renderers/metropolis.cpp
GeneratePath :229-283, Lpath :345-392, Lbidir :395-470). A camera
subpath and a light subpath are generated from disjoint slices of each
chain's primary-sample vector, then every non-specular (camera i, light
j) vertex pair is connected with a visibility ray; each completed path
length k is down-weighted by 1/(k - nSpecularVertices[k]), as the
reference does (metropolis.cpp:449-452).

Both subpaths are generated wavefront-style for W chains in lockstep,
one vertex at a time. The camera vertices are then visited in order (a
Python loop over T <= maxdepth vertices, the JAX package's scan), with
the same order of accumulation into L. At camera vertex i the
connections to all Tl light vertices run as one batch of [Tl * W]
lanes: one BSDF evaluation per side and one any-hit visibility query
(scene.intersect_p, which reaches kernel K1 or K2 on a static scene).
Direct lighting at camera vertices uses the light-sampling estimator
alone (estimate_direct with mis=False).
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import Ray, dot, normalize
from pbrt_tpu_torch.accel.intersect import BIG
from pbrt_tpu_torch.integrators.surface import (
    RAY_EPS,
    _occluded,
    estimate_direct,
    shading_frame,
)
from pbrt_tpu_torch.lights.lighting import area_emission, env_le, sample_light_ray
from pbrt_tpu_torch.materials.bsdf import bsdf_f, bsdf_sample, material_lobes

S = spec.N_BINS

# primary-sample layout (per chain): camera sample, then DPB dims per
# camera vertex, then 5 light-ray dims, then DPB dims per light vertex
CAM_DIMS = 5
DPB = 10
LIGHT_RAY_DIMS = 5


def n_psample_dims(max_depth: int, bidirectional: bool) -> int:
    n = CAM_DIMS + max_depth * DPB
    if bidirectional:
        n += LIGHT_RAY_DIMS + max_depth * DPB
    return n


class _Vertex(NamedTuple):
    valid: torch.Tensor       # [W] vertex exists
    alpha: torch.Tensor       # [W, S] throughput INTO the vertex
    p: torch.Tensor           # [W, 3]
    ns: torch.Tensor          # [W, 3] shading normal
    wprev: torch.Tensor       # [W, 3] direction back toward the previous vertex
    spec: torch.Tensor        # [W] sampled bounce at the vertex was specular
    nspec_comp: torch.Tensor  # [W] number of specular BxDF components
    le: torch.Tensor          # [W, S] emitted radiance toward wprev
    lobes: object
    frame: object


class _Escape(NamedTuple):
    alpha: torch.Tensor      # [W, S] throughput of the escaping ray
    d: torch.Tensor          # [W, 3]
    escaped: torch.Tensor    # [W]
    prev_spec: torch.Tensor  # [W] bounce that produced the escape was specular
    all_spec: torch.Tensor   # [W] path prefix was all-specular


def _batch_map(fn, *tuples):
    """fn over the per-lane tensors of NamedTuples of one type (nested
    tuples recursively); the shared measured tables and absent fields
    come from the first."""
    first = tuples[0]
    out = {}
    for f, v in first._asdict().items():
        if v is None or f == "meas_tables":
            out[f] = v
        elif hasattr(v, "_asdict"):
            out[f] = _batch_map(fn, *(getattr(t, f) for t in tuples))
        else:
            out[f] = fn([getattr(t, f) for t in tuples])
    return type(first)(**out)


def _gen_subpath(scene, ray: Ray, alpha0, valid0, u_fn, max_len: int, with_le: bool):
    """Reference metropolis.cpp GeneratePath (:229-283), wavefront form.
    u_fn(i, dim): psample for vertex i; dims 4..7 bsdf, 8 RR.
    Returns (vertices, escape_record)."""
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    W = ray.o.shape[0]
    dev = ray.o.device
    zero = torch.zeros((), device=dev)
    alpha = alpha0
    alive = valid0
    prev_spec = torch.ones((W,), dtype=torch.bool, device=dev)
    all_spec = torch.ones((W,), dtype=torch.bool, device=dev)
    no = torch.zeros((W,), dtype=torch.bool, device=dev)
    esc = _Escape(alpha=torch.zeros((W, S), device=dev), d=ray.d, escaped=no, prev_spec=no,
                  all_spec=no)
    verts: List[_Vertex] = []
    cur = ray
    for i in range(max_len):
        hit = scene.intersect(cur)
        esc_now = alive & ~hit.valid
        esc = _Escape(
            alpha=torch.where(esc_now[:, None], alpha, esc.alpha),
            d=torch.where(esc_now[:, None], cur.d, esc.d),
            escaped=esc.escaped | esc_now,
            prev_spec=torch.where(esc_now, prev_spec, esc.prev_spec),
            all_spec=torch.where(esc_now, all_spec, esc.all_spec),
        )
        v_valid = alive & hit.valid
        lobes = material_lobes(eval_bsdf_params(scene, hit))
        frame = shading_frame(scene, hit)
        wprev = -normalize(cur.d)
        if with_le and scene.lights is not None:
            le = area_emission(scene.lights, torch.clamp(hit.light, min=0), hit.ng, wprev)
            le = torch.where(((hit.light >= 0) & v_valid)[:, None], le, zero)
        else:
            le = torch.zeros((W, S), device=dev)
        nspec_comp = ((torch.sum(lobes.spec_r, -1) > 0).to(torch.int64)
                      + (torch.sum(lobes.spec_t, -1) > 0).to(torch.int64))
        bs = bsdf_sample(lobes, frame, wprev, u_fn(i, 4), u_fn(i, 5), u_fn(i, 6), u_fn(i, 7))
        verts.append(_Vertex(valid=v_valid, alpha=alpha, p=hit.p, ns=frame.ns, wprev=wprev,
                             spec=bs.is_specular, nspec_comp=nspec_comp, le=le, lobes=lobes,
                             frame=frame))
        # continuation with the reference's per-vertex RR (:270-276)
        cos_i = torch.abs(dot(bs.wi, frame.ns))
        path_scale = bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[:, None]
        ok = bs.valid & ~spec.is_black(path_scale)
        rr_prob = torch.clamp(spec.y(path_scale), 0.0, 1.0)
        survive = u_fn(i, 8) <= rr_prob
        alpha = alpha * path_scale / torch.clamp(rr_prob, min=1e-9)[:, None]
        prev_spec = bs.is_specular
        all_spec = all_spec & bs.is_specular
        alive = v_valid & ok & survive
        alpha = torch.where(alive[:, None], alpha, zero)
        cur = Ray(hit.p + bs.wi * RAY_EPS, bs.wi, torch.zeros((W,), device=dev),
                  torch.full((W,), BIG, device=dev), cur.time)
    return verts, esc


def path_l_psamples(scene, camera, film, u, max_depth: int, bidirectional: bool = True,
                    skip_direct: bool = False):
    """Full MLT path contribution from a primary-sample vector u [W, D].
    Returns (px, py, L [W, S]). skip_direct mirrors the reference's
    doDirectSeparately gating (contributions along all-specular prefixes
    are left to the separate direct-lighting pass, metropolis.cpp
    :354-360,416-422)."""
    W = u.shape[0]
    dev = u.device
    zero = torch.zeros((), device=dev)
    px = film.x0 + u[:, 0] * film.nx
    py = film.y0 + u[:, 1] * film.ny
    ray, rw = camera.generate_rays(px, py, u[:, 2], u[:, 3], u[:, 4])
    alpha0 = torch.ones((W, S), device=dev) * rw[:, None]
    ones_w = torch.ones((W,), dtype=torch.bool, device=dev)

    def u_cam(i, dim):
        return u[:, CAM_DIMS + i * DPB + dim]

    cam_verts, esc = _gen_subpath(scene, ray, alpha0, ones_w, u_cam, max_depth, with_le=True)

    light_verts: List[_Vertex] = []
    l_valid0 = torch.zeros((W,), dtype=torch.bool, device=dev)
    if bidirectional and scene.lights is not None:
        lb = CAM_DIMS + max_depth * DPB
        li, pmf = scene.light_dist.sample_discrete(u[:, lb])
        world_c = torch.as_tensor(0.5 * (scene.world_lo + scene.world_hi), dtype=torch.float32,
                                  device=dev)
        world_rad = float(np.linalg.norm(scene.world_hi - scene.world_lo) * 0.5) + 1e-3
        lr = sample_light_ray(scene.lights, li, world_c, world_rad, u[:, lb + 1], u[:, lb + 2],
                              u[:, lb + 3], u[:, lb + 4])
        l_alpha0 = lr.alpha / torch.clamp(pmf, min=1e-12)[:, None]
        l_valid0 = ~spec.is_black(l_alpha0)
        lray = Ray(lr.o + lr.d * RAY_EPS, lr.d, torch.zeros((W,), device=dev),
                   torch.full((W,), BIG, device=dev), ray.time)

        def u_lt(j, dim):
            return u[:, lb + LIGHT_RAY_DIMS + j * DPB + dim]

        light_verts, _ = _gen_subpath(scene, lray, l_alpha0, l_valid0, u_lt, max_depth,
                                      with_le=False)

    T, Tl = len(cam_verts), len(light_verts)
    # nSpecularVertices[k]: specular (i, j) pairs completing length k
    # (reference metropolis.cpp:405-411) -> [k_max, W]
    k_max = T + Tl + 2
    nspec = torch.zeros((k_max, W), device=dev)
    if Tl > 0:
        for i, vc in enumerate(cam_verts):
            for j, vl in enumerate(light_verts):
                pair = (vc.spec | vl.spec) & vc.valid & vl.valid
                nspec[i + j + 2] += pair.to(torch.float32)
        # the light vertices as one [Tl * W] batch
        lt = _batch_map(lambda xs: torch.cat(xs, 0), *light_verts)
        time_f = ray.time.repeat(Tl)

    L = torch.zeros((W, S), device=dev)
    prev_spec = ones_w
    all_spec = ones_w
    for i, vc in enumerate(cam_verts):
        gate = ~all_spec if skip_direct else ones_w
        # emission toward the camera path (only after specular bounces;
        # diffuse-bounce emission is covered by the previous vertex's Ld)
        L = L + torch.where((prev_spec & gate & vc.valid)[:, None], vc.alpha * vc.le, zero)
        # bidirectional MIS weight of the direct strategy, only on lanes
        # that have a light subpath (the reference's Lpath vs Lbidir)
        wt_d = torch.where(l_valid0, 1.0 / torch.clamp(float(i + 1) - nspec[i + 1], min=1.0),
                           torch.ones((), device=dev))
        u_i = u[:, CAM_DIMS + i * DPB:CAM_DIMS + (i + 1) * DPB]
        Ld = estimate_direct(scene, vc.lobes, vc.frame, vc.p, vc.wprev, u_i[:, 0], u_i[:, 1],
                             u_i[:, 2], vc.valid & gate, time=ray.time, mis=False)
        L = L + vc.alpha * Ld * wt_d[:, None]

        # connect to every light vertex at once (reference :436-462)
        if Tl > 0:
            vc_f = _batch_map(lambda xs: xs[0].repeat((Tl,) + (1,) * (xs[0].dim() - 1)), vc)
            ok = vc_f.valid & lt.valid & ~vc_f.spec & ~lt.spec
            w_vec = lt.p - vc_f.p
            dist2 = torch.clamp(torch.sum(w_vec * w_vec, -1), min=1e-12)
            w_dir = w_vec / torch.sqrt(dist2)[:, None]
            fc = (bsdf_f(vc_f.lobes, vc_f.frame, vc_f.wprev, w_dir)
                  * (1.0 + vc_f.nspec_comp.to(torch.float32))[:, None])
            fl = (bsdf_f(lt.lobes, lt.frame, -w_dir, lt.wprev)
                  * (1.0 + lt.nspec_comp.to(torch.float32))[:, None])
            ok = ok & ~spec.is_black(fc) & ~spec.is_black(fl)
            occ = _occluded(scene, vc_f.p, w_dir, torch.sqrt(dist2), ok, time=time_f)
            ok = ok & ~occ
            k_i = torch.arange(Tl, device=dev) + (i + 2)
            path_wt = 1.0 / torch.clamp(k_i[:, None].to(torch.float32) - nspec[k_i], min=1.0)
            g = torch.abs(dot(vc_f.ns, w_dir)) * torch.abs(dot(lt.ns, w_dir)) / dist2
            contrib = vc_f.alpha * fc * fl * lt.alpha * (g * path_wt.reshape(-1))[:, None]
            contrib = torch.where(ok[:, None], contrib, zero)
            L = L + contrib.reshape(Tl, W, S).sum(0)

        prev_spec = torch.where(vc.valid, vc.spec, prev_spec)
        all_spec = all_spec & (vc.spec | ~vc.valid)

    # escaped-ray environment contribution (reference :383-388,464-469)
    if scene.lights is not None and scene.lights.envs:
        gate_esc = ~esc.all_spec if skip_direct else ones_w
        le_env = env_le(scene.lights, esc.d)
        L = L + torch.where((esc.escaped & esc.prev_spec & gate_esc)[:, None],
                            esc.alpha * le_env, zero)
    return px, py, L
