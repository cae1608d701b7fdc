"""surfacepoints renderer: points spread over the scene's surfaces.

Port of pbrt_tpu/renderers/surfacepoints.py (reference renderers/
surfacepoints.cpp:114-285, whose ray-repulsion points feed
dipolesubsurface): area-weighted samples of the triangles and of the
full spheres, thinned on a grid of cell minDist (the first point in
each cell stays), on the host. The RNG stream is the JAX package's draw
for draw, its two dead placeholder draws included, so both packages make
the same points bit for bit. Only triangles and spheres get area: disks and
the other quadrics get no points (ROADMAP R21).
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.core.error import info
from pbrt_tpu_torch.shapes.registry import QUAD_SPHERE

MAX_POINTS = 1 << 18   # candidates before thinning


def generate_surface_points(scene, min_dist: float, seed: int = 0, oversample: int = 8):
    """-> (p [P, 3], n [P, 3], area [P]) float32 host arrays."""
    rng = np.random.RandomState(seed)
    geom = scene.geom
    v0, e1, e2 = (x.cpu().numpy() for x in (geom.tri_v0, geom.tri_e1, geom.tri_e2))
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1) if len(v0) else np.zeros(0)
    qt, qo2w, qp = (x.cpu().numpy() for x in (geom.quad_type, geom.quad_o2w, geom.quad_params))
    radii = [abs(float(qp[i, 0])) for i in range(len(qt))]
    sphere_areas = [4.0 * np.pi * r * r if qt[i] == QUAD_SPHERE else 0.0
                    for i, r in enumerate(radii)]
    total_area = float(areas.sum()) + sum(sphere_areas)
    if total_area <= 0:
        return (np.zeros((0, 3), np.float32),) * 2 + (np.zeros(0, np.float32),)
    n_target = max(16, int(oversample * total_area / max(min_dist ** 2, 1e-12)))
    n_target = min(n_target, MAX_POINTS)

    pts, nrms = [], []
    if len(v0) and areas.sum() > 0:
        k = int(n_target * areas.sum() / total_area)
        if k > 0:
            cdf = np.cumsum(areas) / areas.sum()
            ti = np.searchsorted(cdf, rng.rand(k))
            rng.rand(k)   # the JAX package's b0 and b1 placeholder draws:
            rng.rand(k)   # kept so that the stream stays the same
            u = rng.rand(k)
            su = np.sqrt(rng.rand(k))
            b0, b1 = 1.0 - su, u * su
            p = v0[ti] + b0[:, None] * e1[ti] + b1[:, None] * e2[ti]
            n = np.cross(e1[ti], e2[ti])
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            pts.append(p)
            nrms.append(n)
    for i, sa in enumerate(sphere_areas):
        k = int(n_target * sa / total_area) if sa > 0 else 0
        if k == 0:
            continue
        z = 1.0 - 2.0 * rng.rand(k)
        phi = 2.0 * np.pi * rng.rand(k)
        r_ = np.sqrt(np.maximum(0.0, 1.0 - z * z))
        dirs = np.stack([r_ * np.cos(phi), r_ * np.sin(phi), z], -1)
        p_obj = dirs * radii[i]
        p_w = (qo2w[i][:3, :3] @ p_obj.T).T + qo2w[i][:3, 3]
        n_w = (np.linalg.inv(qo2w[i][:3, :3]).T @ dirs.T).T
        n_w /= np.maximum(np.linalg.norm(n_w, axis=-1, keepdims=True), 1e-12)
        pts.append(p_w.astype(np.float32))
        nrms.append(n_w.astype(np.float32))
    p = np.concatenate(pts).astype(np.float32)
    n = np.concatenate(nrms).astype(np.float32)

    # thinning: the first point of each cell of side minDist stays
    cell = np.floor(p / max(min_dist, 1e-9)).astype(np.int64)
    key = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791)
    keep = np.sort(np.unique(key, return_index=True)[1])
    p, n = p[keep], n[keep]
    area = np.full(len(p), total_area / max(len(p), 1), np.float32)
    info(f"surfacepoints: {len(p)} points (minDist {min_dist})")
    return p, n, area


def render_surface_points(scene, ro, options=None):
    """Renderer entry: write the point file, an npz with p, n and area
    (reference :284-285) -> {"points", "file"}."""
    options = options or {}
    p = ro.renderer_params
    min_dist = p.find_one_float("minsampledistance", 0.25)
    fn = p.find_one_string("filename", "sp.npz")
    p.report_unused('in renderer "surfacepoints"')
    pts, nrms, area = generate_surface_points(scene, min_dist, int(options.get("seed", 0)))
    np.savez(fn, p=pts, n=nrms, area=area)
    info(f"Wrote surface points to {fn}")
    return {"points": len(pts), "file": fn}
