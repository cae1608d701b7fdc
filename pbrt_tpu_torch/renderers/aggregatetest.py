"""Randomized differential testing of the acceleration structure.

Port of pbrt_tpu/renderers/aggregatetest.py (reference renderers/
aggregatetest.cpp:61-119): cast random rays (origins in the padded
world box, normal-distributed directions with an axis-degenerate slice)
and compare the binary-BVH walk (accel/bvh.py t_pass_bvh) against
exhaustive intersection of every primitive, warning on disagreement.
The rays come from the same NumPy RandomState(seed) stream as the JAX
package's. As there, a scene with no binary tree (the packet pipeline,
the flat t-pass, the block scan, or a grid or kd-tree) is not tested:
the renderer logs it and reports 0.
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core.error import info, warning
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.accel.bvh import t_pass_bvh
from pbrt_tpu_torch.accel.intersect import t_pass_all

# what the last run_aggregate_test did (read by chip_smoke.py): rays
# traced, batches, mismatches
last_stats: dict = {}


def run_aggregate_test(scene, ro, options=None, n_iters: int = None, seed: int = 0,
                       batch: int = 4096):
    """Returns the number of mismatches (0 = pass)."""
    options = options or {}
    n_iters = n_iters or ro.renderer_params.find_one_int("niters", 100000)
    if options.get("quick"):
        n_iters = min(n_iters, 10000)
    rng = np.random.RandomState(seed)
    lo = np.asarray(scene.world_lo) - 1.0
    hi = np.asarray(scene.world_hi) + 1.0
    last_stats.clear()
    last_stats.update(rays=0, batches=0, mismatches=0)
    bvh = scene.accel.bvh
    if bvh is None:
        info("aggregatetest: no BVH built (tiny scene); brute force is the accel")
        return 0

    device = scene.geom.tri_v0.device
    mismatches = 0
    n_batches = (n_iters + batch - 1) // batch
    for _ in range(n_batches):
        o = rng.uniform(lo, hi, size=(batch, 3)).astype(np.float32)
        d = rng.normal(size=(batch, 3)).astype(np.float32)
        # axis-degenerate directions for a slice of rays (reference :75)
        k = batch // 8
        for ax in range(3):
            d[ax * k:(ax + 1) * k] = 0.0
            d[ax * k:(ax + 1) * k, ax] = np.where(rng.rand(k) < 0.5, 1.0, -1.0)
        d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
        zeros = torch.zeros((batch,), device=device)
        ray = Ray(torch.as_tensor(o, device=device), torch.as_tensor(d, device=device), zeros,
                  torch.full((batch,), float("inf"), device=device), zeros)
        t_ref, p_ref = (x.cpu().numpy() for x in t_pass_all(scene.geom, ray))
        t_bvh, p_bvh = (x.cpu().numpy() for x in t_pass_bvh(bvh, scene.geom, ray))
        hit_mismatch = (p_ref >= 0) != (p_bvh >= 0)
        both = (p_ref >= 0) & (p_bvh >= 0)
        # t must agree within float tolerance; prim may differ on exact ties
        t_mismatch = both & (np.abs(t_ref - t_bvh) > 1e-3 * np.maximum(1.0, np.abs(t_ref)))
        bad = hit_mismatch | t_mismatch
        if bad.any():
            mismatches += int(bad.sum())
            i = int(np.argmax(bad))
            warning(f"aggregatetest mismatch: ray o={o[i]} d={d[i]} "
                    f"brute(t={t_ref[i]:.6g}, prim={p_ref[i]}) "
                    f"bvh(t={t_bvh[i]:.6g}, prim={p_bvh[i]})")
        last_stats["rays"] += batch
        last_stats["batches"] += 1
    last_stats["mismatches"] = mismatches
    if mismatches == 0:
        info(f"aggregatetest: {n_iters} rays, no disagreements")
    else:
        warning(f"aggregatetest: {mismatches} disagreements over {n_iters} rays")
    return mismatches
