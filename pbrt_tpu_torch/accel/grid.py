"""Uniform-grid accelerator: host CSR build + lockstep 3DDDA traversal.

Port of pbrt_tpu/accel/grid.py (reference accelerators/grid.{h,cpp}
GridAccel). The host build (NumPy) gives the JAX package's arrays
exactly: voxels per axis by the reference's heuristic 3 * cbrt(nPrims)
/ maxExtent, clamped to [1, 64]; every primitive appended to each voxel
its world box overlaps; the per-voxel lists stored CSR-style (voxel_off
[NV + 1], voxel_prims [M], each voxel's prims in increasing id).

The traversal (t_pass_grid) runs all rays in lockstep, plain torch: each
ray carries its voxel, the DDA's t at the next boundary per axis and a
cursor into the voxel's list. An iteration tests the next CHUNK prims of
the voxel (bvh._leaf_prims_t) or, once the list is exhausted, steps to
the neighbouring voxel; a ray ends when its best hit lies before the
voxel's exit (t_best <= t_exit * (1 + 1e-5)), on any hit for an any-hit
query, or when it leaves the grid. The loop ends on the host, which
reads the stop condition every CHECK_EVERY iterations (one sync each);
iterations after every ray has ended change nothing.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core.error import info
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.accel.bvh import _leaf_prims_t, min_first, prim_bounds
from pbrt_tpu_torch.accel.intersect import BIG, SceneGeom, reconstruct, t_pass_all

CHUNK = 4          # prims tested per iteration (the BVH's LEAF_MAX)
MAX_AXIS_VOX = 64  # reference grid.cpp clamps nVoxels[axis] to 64
CHECK_EVERY = 8    # iterations between reads of the stop condition
# what the grid walks did since the last reset (chip_smoke.py [27])
walk_stats = {"traversals": 0, "iterations": 0}


class Grid(NamedTuple):
    """The grid on the device (float32 bounds and widths, int64 counts
    and lists)."""

    lo: torch.Tensor           # [3] world bounds of the grid
    hi: torch.Tensor           # [3]
    n_vox: torch.Tensor        # [3] voxels per axis
    width: torch.Tensor        # [3] voxel width
    voxel_off: torch.Tensor    # [NV + 1] CSR offsets (x fastest)
    voxel_prims: torch.Tensor  # [M] global prim ids


def build_grid_arrays(lo_p: np.ndarray, hi_p: np.ndarray) -> Optional[dict]:
    """The grid over primitive boxes lo_p/hi_p [P, 3] as NumPy arrays
    (the JAX package's dtypes: float32 bounds, int32 counts), or None
    for no primitives."""
    n = len(lo_p)
    if n == 0:
        return None
    wlo = lo_p.min(0) - 1e-4
    whi = hi_p.max(0) + 1e-4
    extent = whi - wlo
    max_ext = float(extent.max())
    # reference heuristic: voxelsPerUnitDist = 3 * nPrims^(1/3) / maxExtent
    vpud = 3.0 * n ** (1.0 / 3.0) / max(max_ext, 1e-9)
    nv = np.clip(np.round(extent * vpud).astype(np.int64), 1, MAX_AXIS_VOX)
    width = extent / nv
    inv_w = 1.0 / np.maximum(width, 1e-12)
    # voxel coordinate ranges each prim's box overlaps
    lo_v = np.clip(((lo_p - wlo) * inv_w).astype(np.int64), 0, nv - 1)
    hi_v = np.clip(((hi_p - wlo) * inv_w).astype(np.int64), 0, nv - 1)
    ext = hi_v - lo_v + 1
    counts = np.prod(ext, axis=1)
    total = int(counts.sum())
    NV = int(np.prod(nv))
    # (voxel, prim) pairs in prim order, each prim's voxels x fastest,
    # then a stable sort by voxel
    prim_ids = np.repeat(np.arange(n, dtype=np.int64), counts)
    local = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    ex = ext[prim_ids]
    lv = lo_v[prim_ids]
    vx = lv[:, 0] + local % ex[:, 0]
    vy = lv[:, 1] + (local // ex[:, 0]) % ex[:, 1]
    vz = lv[:, 2] + local // (ex[:, 0] * ex[:, 1])
    vox_ids = (vz * nv[1] + vy) * nv[0] + vx
    order = np.argsort(vox_ids, kind="stable")
    off = np.concatenate([[0], np.cumsum(np.bincount(vox_ids, minlength=NV))])
    info(f"Grid: {nv[0]}x{nv[1]}x{nv[2]} voxels, {total} prim refs over {n} prims")
    return {"lo": np.asarray(wlo, np.float32), "hi": np.asarray(whi, np.float32),
            "n_vox": np.asarray(nv, np.int32), "width": np.asarray(width, np.float32),
            "voxel_off": np.asarray(off, np.int32),
            "voxel_prims": np.asarray(prim_ids[order], np.int32)}


def grid_from_arrays(a: dict, device) -> Grid:
    """The grid's arrays (build_grid_arrays' keys) as device tensors."""
    f = lambda k: torch.as_tensor(np.asarray(a[k]), dtype=torch.float32, device=device)
    i = lambda k: torch.as_tensor(np.asarray(a[k]), dtype=torch.int64, device=device)
    return Grid(lo=f("lo"), hi=f("hi"), n_vox=i("n_vox"), width=f("width"),
                voxel_off=i("voxel_off"), voxel_prims=i("voxel_prims"))


def build_grid(geom: SceneGeom) -> Optional[Grid]:
    a = build_grid_arrays(*prim_bounds(geom))
    return None if a is None else grid_from_arrays(a, geom.tri_v0.device)


def t_pass_grid(grid: Grid, geom: SceneGeom, ray: Ray, any_hit: bool = False):
    """Lockstep 3DDDA over the grid. Returns (t [R], prim [R] int64;
    BIG and -1 on a miss)."""
    R = ray.o.shape[0]
    dev = ray.o.device
    o, d = ray.o, ray.d
    big = torch.full((), BIG, device=dev)
    axis_ok = torch.abs(d) > 1e-20
    safe_d = torch.where(axis_ok, d, torch.full((), 1e-20, device=dev))
    inv_d = 1.0 / safe_d
    # the ray's overlap with the grid's bounds (slab test)
    t_lo = (grid.lo[None] - o) * inv_d
    t_hi = (grid.hi[None] - o) * inv_d
    tn = torch.maximum(torch.amax(torch.minimum(t_lo, t_hi), -1), ray.tmin)
    tmax0 = torch.where(torch.isfinite(ray.tmax), ray.tmax, big)
    tf = torch.minimum(torch.amin(torch.maximum(t_lo, t_hi), -1), tmax0)
    alive = tn <= tf
    # entry voxel and DDA increments
    p_in = o + safe_d * tn[:, None]
    nvox = grid.n_vox[None]
    vox = torch.minimum(torch.clamp(((p_in - grid.lo[None]) / grid.width[None]).to(torch.int64),
                                    min=0), nvox - 1)
    step = torch.where(d >= 0, 1, -1)
    next_bound = grid.lo[None] + (vox + (step > 0)).to(torch.float32) * grid.width[None]
    t_next = torch.where(axis_ok, tn[:, None] + (next_bound - p_in) * inv_d, big)
    dt = torch.where(axis_ok, torch.abs(grid.width[None] * inv_d), big)
    out = torch.where(step > 0, nvox, -1)

    t_best = tmax0
    prim_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    cursor = torch.zeros((R,), dtype=torch.int64, device=dev)
    M = grid.voxel_prims.shape[0]
    n_last = grid.voxel_off.shape[0] - 2
    nvx, nvy = grid.n_vox[0], grid.n_vox[1]
    k = torch.arange(CHUNK, device=dev)
    axes = torch.arange(3, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    n = 0
    while True:
        if n % CHECK_EVERY == 0 and not bool(alive.any()):
            break
        n += 1
        iters = iters + alive.any()
        vid = torch.clamp((vox[:, 2] * nvy + vox[:, 1]) * nvx + vox[:, 0], 0, n_last)
        start = grid.voxel_off[vid]
        count = grid.voxel_off[vid + 1] - start
        # test the next CHUNK prims of this voxel
        in_list = ((cursor[:, None] + k[None, :]) < count[:, None]) & alive[:, None]
        if M > 0:
            pidx = torch.clamp(start[:, None] + cursor[:, None] + k[None, :], 0, M - 1)
            gids = torch.where(in_list, grid.voxel_prims[pidx], minus1)
        else:
            gids = torch.full((R, CHUNK), -1, dtype=torch.int64, device=dev)
        t_c, v_c = _leaf_prims_t(geom, gids, o, d, ray.tmin, t_best, ray.time)
        t_c = torch.where(v_c, t_c, big)
        t_leaf, jbest = min_first(t_c)
        g_leaf = gids.gather(1, jbest[:, None])[:, 0]
        better = alive & (t_leaf < t_best)
        t_best = torch.where(better, t_leaf, t_best)
        prim_best = torch.where(better, g_leaf, prim_best)

        done_chunk = cursor + CHUNK >= count
        cursor = torch.where(done_chunk, 0, cursor + CHUNK)
        # DDA step once the voxel's list is exhausted
        t_exit, axis = min_first(t_next)
        hit_here = prim_best >= 0
        if any_hit:
            terminate = hit_here
        else:   # early out: the best hit lies inside this voxel
            terminate = hit_here & (t_best <= t_exit * (1 + 1e-5))
        do_step = alive & done_chunk
        on_axis = do_step[:, None] & (axes[None, :] == axis[:, None])
        vox = torch.where(on_axis, vox + step, vox)
        t_next = torch.where(on_axis, t_next + dt, t_next)
        exited = torch.any(vox == out, -1) | (t_exit > tmax0)
        # rays mid-voxel (chunking) stay alive
        alive = alive & ~(do_step & (terminate | exited))
    walk_stats["traversals"] += 1
    walk_stats["iterations"] += int(iters)
    return torch.where(prim_best >= 0, t_best, big), prim_best


class GridScene(NamedTuple):
    """Geometry + uniform-grid acceleration (Accelerator "grid"). The
    packet, flat and binary-tree handles of accel.bvh.BvhScene are None,
    so the rest of the package treats it as a BvhScene."""

    geom: SceneGeom
    grid: Optional[Grid]
    tri_soa: object = None
    wide: object = None
    bvh: object = None

    def _t_pass(self, ray: Ray, any_hit: bool = False):
        if self.grid is None:   # no primitives: exhaustion, quadrics folded
            return t_pass_all(self.geom, ray)
        return t_pass_grid(self.grid, self.geom, ray, any_hit=any_hit)

    def intersect(self, ray: Ray, coherent: bool = False):
        t, prim = self._t_pass(ray)
        return reconstruct(self.geom, ray, t, prim)

    def intersect_p(self, ray: Ray, coherent: bool = False):
        _, prim = self._t_pass(ray, any_hit=True)
        return prim >= 0


def make_grid_accel(geom: SceneGeom) -> GridScene:
    return GridScene(geom=geom, grid=build_grid(geom))
