"""SAH kd-tree accelerator: host edge-event build + lockstep short-stack
traversal.

Port of pbrt_tpu/accel/kdtree.py (reference accelerators/kdtreeaccel
.{h,cpp} KdTreeAccel). The host build is the JAX package's, line for
line, and gives its arrays exactly: exact edge-event SAH with the
reference's cost model (intersectcost 80, traversalcost 1, emptybonus
0.5, maxprims 1, maxdepth 8 + 1.3 log2(N) by default, clamped to the
traversal stack's MAX_DEPTH with a warning), flattened to

  node_split [N]    float32 split plane position
  node_meta  [N, 3] interior (axis 0..2, above_child, 0),
                    leaf (3, prim_offset, n_prims)
  prim_ids   [P]    the leaves' prim lists (global ids)

The traversal (t_pass_kdtree) is the classic (node, t_near, t_far)
descent with a short stack of MAX_DEPTH entries per ray, all rays in
lockstep, plain torch; a push past the stack is dropped, as in the JAX
package. Leaves are tested LEAF_MAX prims per iteration (a cursor walks
larger leaves); once a leaf's hit lies inside the popped interval the
ray's stack is emptied (front-to-back early exit). The loop ends on the
host, which reads the stop condition every CHECK_EVERY iterations;
iterations after every stack is empty change nothing.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core.error import info, warning
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.accel.bvh import _leaf_prims_t, min_first, prim_bounds
from pbrt_tpu_torch.accel.intersect import BIG, SceneGeom, reconstruct, t_pass_all

MAX_DEPTH = 64    # traversal stack depth
LEAF_MAX = 4      # prims of a leaf tested per iteration
CHECK_EVERY = 8   # iterations between reads of the stop condition
_LEAF_FLAG = 3
# what the kd-tree walks did since the last reset (chip_smoke.py [27])
walk_stats = {"traversals": 0, "iterations": 0}


class KdTree(NamedTuple):
    """The tree on the device (float32 bounds and planes, int64 meta
    and prim lists)."""

    lo: torch.Tensor          # [3] world bounds
    hi: torch.Tensor          # [3]
    node_split: torch.Tensor  # [N]
    node_meta: torch.Tensor   # [N, 3]
    prim_ids: torch.Tensor    # [P]


def build_kdtree_arrays(lo_p: np.ndarray, hi_p: np.ndarray, isect_cost: float = 80.0,
                        trav_cost: float = 1.0, empty_bonus: float = 0.5,
                        max_prims: int = 1, max_depth: int = 0) -> Optional[dict]:
    """The tree over primitive boxes lo_p/hi_p [P, 3] as NumPy arrays
    (the JAX package's dtypes), or None for no primitives."""
    n = len(lo_p)
    if n == 0:
        return None
    if max_depth <= 0:
        # reference kdtreeaccel.cpp: 8 + 1.3 * log2(N)
        max_depth = int(round(8 + 1.3 * np.log2(max(n, 1))))
    if max_depth > MAX_DEPTH:
        # the traversal short stack is MAX_DEPTH deep and silently drops
        # pushes past it; never build deeper than we can traverse
        warning(f"kdtree maxdepth {max_depth} clamped to traversal stack "
                f"depth {MAX_DEPTH}")
        max_depth = MAX_DEPTH

    wlo = lo_p.min(0).astype(np.float64)
    whi = hi_p.max(0).astype(np.float64)

    split_pos: list = []
    meta: list = []
    order: list = []

    def add_node():
        split_pos.append(0.0)
        meta.append((0, 0, 0))
        return len(meta) - 1

    def set_leaf(idx, prims):
        # leaves may exceed LEAF_MAX; traversal chunks through them with a
        # per-ray cursor (see t_pass_kdtree)
        split_pos[idx] = 0.0
        meta[idx] = (_LEAF_FLAG, len(order), len(prims))
        order.extend(int(p) for p in prims)

    def recurse(prims: np.ndarray, nlo, nhi, depth: int, bad_refines: int):
        idx = add_node()
        if len(prims) <= max_prims or depth == 0:
            set_leaf(idx, prims)
            return idx
        # exact edge-event SAH over the three axes
        # (reference kdtreeaccel.cpp BuildTree retry loop)
        d = np.maximum(nhi - nlo, 0.0)
        inv_sa = 1.0 / max(
            2.0 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2]), 1e-30)
        old_cost = isect_cost * len(prims)
        best = (np.inf, -1, 0.0)  # (cost, axis, position)
        axis0 = int(np.argmax(d))
        for trial in range(3):
            axis = (axis0 + trial) % 3
            starts = lo_p[prims, axis]
            ends = hi_p[prims, axis]
            # events: (pos, type) with type 0=start(open) before 1=end? pbrt
            # sorts END before START at equal positions
            pos = np.concatenate([starts, ends])
            typ = np.concatenate([np.zeros(len(prims)), np.ones(len(prims))])
            srt = np.lexsort((1.0 - typ, pos))  # ends (typ=1) first on ties
            pos_s = pos[srt]
            is_start = typ[srt] == 0
            n_above = np.full(len(pos_s), 0, np.int64)
            # sweep: below count after processing all events < here
            below_inc = np.cumsum(is_start.astype(np.int64))
            above_dec = len(prims) - np.cumsum((~is_start).astype(np.int64))
            # at event i (a candidate plane at pos_s[i]):
            #   nAbove = prims whose end > pos  -> above_dec adjusted pre-event
            #   nBelow = prims whose start < pos -> below_inc pre-event
            n_below = np.concatenate([[0], below_inc[:-1]])
            n_above = np.concatenate([[len(prims)], above_dec[:-1]])
            # pbrt decrements nAbove when passing an END event before
            # evaluating the plane at it:
            n_above = np.where(~is_start, n_above - 1, n_above)
            inside = (pos_s > nlo[axis]) & (pos_s < nhi[axis])
            # SA of the two children for each candidate
            oth = [a for a in range(3) if a != axis]
            sa_base = d[oth[0]] * d[oth[1]]
            sa_edge = d[oth[0]] + d[oth[1]]
            below_sa = 2.0 * (sa_base + (pos_s - nlo[axis]) * sa_edge)
            above_sa = 2.0 * (sa_base + (nhi[axis] - pos_s) * sa_edge)
            pb = below_sa * inv_sa
            pa = above_sa * inv_sa
            eb = np.where((n_above == 0) | (n_below == 0), empty_bonus, 0.0)
            cost = trav_cost + isect_cost * (1.0 - eb) * (pb * n_below + pa * n_above)
            cost = np.where(inside, cost, np.inf)
            if cost.size and cost.min() < best[0]:
                i = int(np.argmin(cost))
                best = (float(cost[i]), axis, float(pos_s[i]))
            if best[1] >= 0:
                break  # found a plane on this axis; pbrt retries only on failure
        cost_best, axis, pos = best
        if cost_best > old_cost:
            bad_refines += 1
        if (cost_best > 4.0 * old_cost and len(prims) < 16) or axis < 0 \
                or bad_refines == 3:
            set_leaf(idx, prims)
            return idx
        # flat prims exactly on the plane go to both sides (safe; the
        # event-sorted reference handles this via edge ordering)
        flat = (lo_p[prims, axis] == pos) & (hi_p[prims, axis] == pos)
        below = prims[(lo_p[prims, axis] < pos) | flat]
        above = prims[(hi_p[prims, axis] > pos) | flat]
        if len(below) == len(prims) and len(above) == len(prims):
            # degenerate: the plane separates nothing
            set_leaf(idx, prims)
            return idx
        # An empty side is exactly what the empty-bonus rewards: recurse
        # with an empty leaf for it to cut away the empty space (the
        # reference creates the empty child too, kdtreeaccel.cpp).
        blo, bhi = nlo.copy(), nhi.copy()
        bhi[axis] = pos
        alo, ahi = nlo.copy(), nhi.copy()
        alo[axis] = pos
        recurse(below, blo, bhi, depth - 1, bad_refines)
        above_idx_pos = idx  # fill after the below subtree is emitted
        a_idx = recurse(above, alo, ahi, depth - 1, bad_refines)
        meta[above_idx_pos] = (axis, a_idx, 0)
        split_pos[above_idx_pos] = pos
        return idx

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    try:
        recurse(np.arange(n), wlo.copy(), whi.copy(), max_depth, 0)
    finally:
        sys.setrecursionlimit(old)

    info(f"KdTree: {len(meta)} nodes over {n} prims, depth<={max_depth}")
    return {"lo": np.asarray(wlo, np.float32), "hi": np.asarray(whi, np.float32),
            "node_split": np.asarray(split_pos, np.float32),
            "node_meta": np.asarray(meta, np.int32),
            "prim_ids": np.asarray(order, np.int32) if order else np.zeros(1, np.int32)}


def kdtree_from_arrays(a: dict, device) -> KdTree:
    """The tree's arrays (build_kdtree_arrays' keys) as device tensors."""
    f = lambda k: torch.as_tensor(np.asarray(a[k]), dtype=torch.float32, device=device)
    i = lambda k: torch.as_tensor(np.asarray(a[k]), dtype=torch.int64, device=device)
    return KdTree(lo=f("lo"), hi=f("hi"), node_split=f("node_split"),
                  node_meta=i("node_meta"), prim_ids=i("prim_ids"))


def build_kdtree(geom: SceneGeom, **kw) -> Optional[KdTree]:
    a = build_kdtree_arrays(*prim_bounds(geom), **kw)
    return None if a is None else kdtree_from_arrays(a, geom.tri_v0.device)


def t_pass_kdtree(kd: KdTree, geom: SceneGeom, ray: Ray, any_hit: bool = False):
    """Lockstep short-stack kd descent. Returns (t [R], prim [R] int64;
    BIG and -1 on a miss)."""
    R = ray.o.shape[0]
    dev = ray.o.device
    o, d = ray.o, ray.d
    big = torch.full((), BIG, device=dev)
    safe_d = torch.where(torch.abs(d) > 1e-20, d, torch.full((), 1e-20, device=dev))
    inv_d = 1.0 / safe_d
    t_lo = (kd.lo[None] - o) * inv_d
    t_hi = (kd.hi[None] - o) * inv_d
    tn0 = torch.maximum(torch.amax(torch.minimum(t_lo, t_hi), -1), ray.tmin)
    tmax0 = torch.where(torch.isfinite(ray.tmax), ray.tmax, big)
    tf0 = torch.minimum(torch.amin(torch.maximum(t_lo, t_hi), -1), tmax0)
    # the root's interval pre-pushed where the ray overlaps the tree's bounds
    s_node = torch.zeros((R, MAX_DEPTH), dtype=torch.int64, device=dev)
    s_tn = torch.zeros((R, MAX_DEPTH), device=dev)
    s_tf = torch.zeros((R, MAX_DEPTH), device=dev)
    s_tn[:, 0] = tn0
    s_tf[:, 0] = tf0
    sp = (tn0 <= tf0).to(torch.int64)
    t_best = tmax0
    prim_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    cursor = torch.zeros((R,), dtype=torch.int64, device=dev)   # chunk offset into the top leaf
    P = kd.prim_ids.shape[0]
    k = torch.arange(LEAF_MAX, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)
    zero_i = torch.zeros((), dtype=torch.int64, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)

    def push(sp, can, node, tn, tf):
        slot = torch.clamp(sp, max=MAX_DEPTH - 1)[:, None]
        for s, v in ((s_node, node), (s_tn, tn), (s_tf, tf)):
            s.scatter_(1, slot, torch.where(can, v, s.gather(1, slot)[:, 0])[:, None])
        return torch.where(can, sp + 1, sp)

    n = 0
    while True:
        if n % CHECK_EVERY == 0 and not bool((sp > 0).any()):
            break
        n += 1
        has = sp > 0
        iters = iters + has.any()
        top = torch.clamp(sp - 1, min=0)[:, None]
        node = torch.where(has, s_node.gather(1, top)[:, 0], zero_i)
        tn = s_tn.gather(1, top)[:, 0]
        tf = torch.minimum(s_tf.gather(1, top)[:, 0], t_best)
        live = has & (tn <= tf * 1.0001 + 1e-6)
        m = kd.node_meta[node]
        flag = m[:, 0]
        is_leaf = flag == _LEAF_FLAG

        # leaf: the next LEAF_MAX prims (the cursor walks larger leaves
        # across iterations; the entry stays on the stack until its
        # list is exhausted)
        first, count = m[:, 1], m[:, 2]
        off = cursor[:, None] + k[None, :]
        pidx = torch.clamp(first[:, None] + off, 0, max(P - 1, 0))
        in_leaf = (off < count[:, None]) & (live & is_leaf)[:, None]
        gids = torch.where(in_leaf, kd.prim_ids[pidx], minus1)
        t_c, v_c = _leaf_prims_t(geom, gids, o, d, ray.tmin, t_best, ray.time)
        t_c = torch.where(v_c, t_c, big)
        t_leaf, jb = min_first(t_c)
        g_leaf = gids.gather(1, jb[:, None])[:, 0]
        better = live & is_leaf & (t_leaf < t_best)
        t_best = torch.where(better, t_leaf, t_best)
        prim_best = torch.where(better, g_leaf, prim_best)

        leaf_done = cursor + LEAF_MAX >= count
        # pop rule: dead entries and exhausted or interior nodes pop; an
        # unfinished leaf stays with an advanced cursor
        stay = live & is_leaf & ~leaf_done
        sp2 = torch.where(has & ~stay, sp - 1, sp)
        cursor = torch.where(stay, cursor + LEAF_MAX, zero_i)
        # front-to-back early out: a hit inside the popped interval ends
        # the ray once the leaf's whole list has been tested
        if any_hit:
            finish = prim_best >= 0
        else:
            finish = (prim_best >= 0) & (t_best <= tf * 1.0001 + 1e-6)
        sp2 = torch.where(live & is_leaf & leaf_done & finish, zero_i, sp2)

        # interior: split-plane classification
        axis = torch.clamp(flag, 0, 2)[:, None]
        split = kd.node_split[node]
        o_ax = o.gather(1, axis)[:, 0]
        d_ax = safe_d.gather(1, axis)[:, 0]
        t_plane = (split - o_ax) * (1.0 / d_ax)
        below_first = (o_ax < split) | ((o_ax == split) & (d_ax <= 0.0))
        below_child, above_child = node + 1, m[:, 1]
        near = torch.where(below_first, below_child, above_child)
        far = torch.where(below_first, above_child, below_child)
        interior = live & ~is_leaf
        only_near = interior & ((t_plane > tf) | (t_plane <= 0.0))
        only_far = interior & ~only_near & (t_plane < tn)
        both = interior & ~only_near & ~only_far
        # push the far interval first (popped second), then the near
        sp3 = push(sp2, (both | only_far) & (sp2 < MAX_DEPTH), far,
                   torch.where(only_far, tn, t_plane), tf)
        sp = push(sp3, (both | only_near) & (sp3 < MAX_DEPTH), near, tn,
                  torch.where(only_near, tf, t_plane))
    walk_stats["traversals"] += 1
    walk_stats["iterations"] += int(iters)
    return torch.where(prim_best >= 0, t_best, big), prim_best


class KdScene(NamedTuple):
    """Geometry + SAH kd-tree acceleration (Accelerator "kdtree"). The
    packet, flat and binary-tree handles of accel.bvh.BvhScene are None,
    so the rest of the package treats it as a BvhScene."""

    geom: SceneGeom
    kd: Optional[KdTree]
    tri_soa: object = None
    wide: object = None
    bvh: object = None

    def _t_pass(self, ray: Ray, any_hit: bool = False):
        if self.kd is None:   # no primitives: exhaustion, quadrics folded
            return t_pass_all(self.geom, ray)
        return t_pass_kdtree(self.kd, self.geom, ray, any_hit=any_hit)

    def intersect(self, ray: Ray, coherent: bool = False):
        t, prim = self._t_pass(ray)
        return reconstruct(self.geom, ray, t, prim)

    def intersect_p(self, ray: Ray, coherent: bool = False):
        _, prim = self._t_pass(ray, any_hit=True)
        return prim >= 0


def make_kdtree_accel(geom: SceneGeom, params=None) -> KdScene:
    """Accelerator "kdtree" factory (reference kdtreeaccel.cpp:475-484)."""
    if params is None:
        return KdScene(geom=geom, kd=build_kdtree(geom))
    return KdScene(geom=geom, kd=build_kdtree(
        geom,
        isect_cost=float(params.find_one_int("intersectcost", 80)),
        trav_cost=float(params.find_one_int("traversalcost", 1)),
        empty_bonus=float(params.find_one_float("emptybonus", 0.5)),
        max_prims=int(params.find_one_int("maxprims", 1)),
        max_depth=int(params.find_one_int("maxdepth", -1))))
