"""BVH accelerator: host build, the binary-BVH walk, and the t-pass
dispatch.

Port of pbrt_tpu/accel/bvh.py. The binary tree comes from the port's
own copy of the reference's native C++ builder (csrc/bvh_builder.cpp,
byte-identical to the reference's, so both packages build the same
tree), compiled with g++ into the port's build directory, over the
reference's primitive bounds (triangles, then quadric boxes, each
unioned with its end-of-shutter bounds in a motion scene). When that
builder cannot be compiled or loaded, or returns no nodes, the port
builds with its copy of the reference's pure-Python builders (SAH with
12 buckets, middle, equal, and AAC over 30-bit Morton codes), whose
trees are array-identical to the reference's Python trees; that is
slower by two orders of magnitude on large scenes, so it warns once.
make_accel routes each scene as the reference's make_accel does on its
TPU:

  - static scenes with at least WIDE_THRESHOLD triangles: the packet
    pipeline (accel/wide_bvh.py collapses the tree into 128-triangle
    leaf blocks without the quadrics; ops/bvh_cuda.py, kernel K2);
  - more than BVH_THRESHOLD primitives otherwise (or force="bvh"): the
    binary tree, walked per ray with a short stack (t_pass_bvh, plain
    torch);
  - other static scenes: the flat t-pass (ops/intersect_cuda.py,
    kernel K1);
  - other motion scenes: the block scan at each ray's time
    (accel/intersect.py t_pass_brute, plain torch).

Motion scenes reach neither kernel, in either package: that is the
reference's own routing, not a fallback. After K1, K2 or the block scan
the quadrics are folded into the triangles' result (accel/intersect.py
quad_t_pass); a scene without triangles folds its quadrics into empty
accumulators. The walk tests triangles and quadrics in its leaves.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core.error import PbrtError, info, warning
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.core.transform import xform_point_affine, xform_vector
from pbrt_tpu_torch.accel import intersect
from pbrt_tpu_torch.accel.intersect import (
    BIG,
    SceneGeom,
    mt_t,
    quad_candidates,
    quad_t_pass,
    reconstruct,
)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
_BUILD_ROOT = os.path.join(_PKG, "_build")
WIDE_THRESHOLD = 8192
BVH_THRESHOLD = 32768   # primitives above which the reference traverses a binary BVH
MAX_DEPTH = 64          # the walk's stack; pushes past it are dropped, as in the reference
LEAF_MAX = 4
WALK_CHECK_EVERY = 8    # t_pass_bvh iterations between reads of the stop condition
# what the walks did since the last reset (chip_smoke.py [19]):
# traversals and stack iterations
walk_stats = {"traversals": 0, "iterations": 0}
_LOCK = threading.Lock()
_LIB = None
_NATIVE_ERROR = None   # why the native builder is unavailable, once known
_native_warned = False  # the Python builders' warning, once a process


class BVH(NamedTuple):
    """Flattened binary tree: first child adjacent. NumPy on the host
    (build_bvh); torch on the device in BvhScene.bvh (node_meta and
    prim_ids as int64)."""

    node_lo: np.ndarray    # [N, 3]
    node_hi: np.ndarray    # [N, 3]
    node_meta: np.ndarray  # [N, 3] int32: (second_child|offset, n_prims, axis)
    prim_ids: np.ndarray   # [P] int32 prim ids (leaf order)

    @property
    def n_nodes(self):
        return self.node_lo.shape[0]


def _load_native():
    """Compile the C++ builder with g++ (the flags of the reference's
    native loader) and load it with ctypes. Raises PbrtError when it
    cannot (no source, no g++, a failed compile or load); the failure is
    remembered, so g++ runs at most once a process."""
    global _LIB, _NATIVE_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _NATIVE_ERROR is not None:
            raise PbrtError(_NATIVE_ERROR)
        try:
            _LIB = _compile_and_load()
        except (OSError, subprocess.SubprocessError) as e:
            _NATIVE_ERROR = f"cannot build the BVH builder: {e}"
        except PbrtError as e:
            _NATIVE_ERROR = str(e)
        if _LIB is None:
            raise PbrtError(_NATIVE_ERROR)
        return _LIB


def _compile_and_load():
    if not os.path.exists(NATIVE_SRC):
        raise PbrtError(f"BVH builder source not found: {NATIVE_SRC}")
    with open(NATIVE_SRC, "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_BUILD_ROOT, f"native-{h}", "libpbrt_native.so")
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", NATIVE_SRC, "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise PbrtError(f"g++ failed building the BVH builder:\n{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.pbrt_build_bvh.restype = ctypes.c_int
    lib.pbrt_build_bvh.argtypes = [fp, fp, ctypes.c_int, ctypes.c_int, fp, fp,
                                   ip, ip, ctypes.c_int]
    return lib


def _tri_bounds(v0, e1, e2):
    p1, p2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    return lo.astype(np.float32), hi.astype(np.float32)


def quad_bounds(quad_o2w: np.ndarray, quad_params: np.ndarray, quad_o2w_end=None):
    """World boxes [Q, 3] of the quadrics (the reference's _prim_bounds:
    the object box [-r, r]^2 x [zmin, zmax] through o2w, corner by
    corner, and through the end-of-shutter o2w too when given)."""
    lo_q = np.zeros((len(quad_params), 3), np.float32)
    hi_q = np.zeros((len(quad_params), 3), np.float32)
    for i in range(len(quad_params)):
        r = abs(float(quad_params[i, 0]))
        zmin, zmax = float(quad_params[i, 1]), float(quad_params[i, 2])
        corners = np.array([[x, y, z] for x in (-r, r) for y in (-r, r) for z in (zmin, zmax)])
        wc = xform_point_affine(quad_o2w[i], corners)
        if quad_o2w_end is not None:
            wc = np.concatenate([wc, xform_point_affine(quad_o2w_end[i], corners)])
        lo_q[i] = wc.min(0)
        hi_q[i] = wc.max(0)
    return lo_q, hi_q


def prim_bounds(geom: SceneGeom):
    """World bounds [P, 3] of every primitive (triangles, then quadrics),
    each unioned with its end-of-shutter bounds in a motion scene (linear
    motion stays within the endpoint hull per vertex)."""
    v0, e1, e2 = (x.cpu().numpy() for x in (geom.tri_v0, geom.tri_e1, geom.tri_e2))
    lo, hi = _tri_bounds(v0, e1, e2)
    if geom.tri_dv0 is not None:
        v0e = v0 + geom.tri_dv0.cpu().numpy()
        lo_e, hi_e = _tri_bounds(v0e, e1 + geom.tri_de1.cpu().numpy(),
                                 e2 + geom.tri_de2.cpu().numpy())
        lo, hi = np.minimum(lo, lo_e), np.maximum(hi, hi_e)
    if geom.n_quads > 0:
        end = None if geom.quad_o2w_end is None else geom.quad_o2w_end.cpu().numpy()
        lo_q, hi_q = quad_bounds(geom.quad_o2w.cpu().numpy(), geom.quad_params.cpu().numpy(),
                                 end)
        lo, hi = np.concatenate([lo, lo_q]), np.concatenate([hi, hi_q])
    return lo.astype(np.float32), hi.astype(np.float32)


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, split_method: str = "sah",
              quads=None, world=None) -> Optional[BVH]:
    """Binary BVH over the triangles (v0, e1, e2) [T, 3] float32, then
    the quadric boxes `quads` = (lo [Q, 3], hi [Q, 3]) if given: prim ids
    T.. are the quadrics, as in the reference. `world` as in
    build_bvh_bounds."""
    lo, hi = _tri_bounds(v0, e1, e2)
    if quads is not None and len(quads[0]):
        lo = np.concatenate([lo, quads[0]]).astype(np.float32)
        hi = np.concatenate([hi, quads[1]]).astype(np.float32)
    return build_bvh_bounds(lo, hi, split_method, world)


def build_bvh_bounds(lo: np.ndarray, hi: np.ndarray, split_method: str = "sah",
                     world=None) -> Optional[BVH]:
    """Binary BVH over primitive boxes lo/hi [P, 3]: the native builder,
    else the Python builders (reference build_bvh). `world` = (world_lo,
    world_hi), the scene's bounds, is AAC's Morton grid in the Python
    build (default: the union of the boxes). An unknown split method
    warns and builds SAH (the reference's native builder maps it to
    SAH)."""
    n = len(lo)
    if n == 0:
        return None
    if split_method not in ("sah", "middle", "equal", "aac"):
        warning(f'BVH split method "{split_method}" unknown; using "sah"')
        split_method = "sah"
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    tree = _native_build(lo, hi, split_method)
    if tree is not None:
        return tree
    if split_method == "aac":
        wl, wh = world if world is not None else (lo.min(0), hi.max(0))
        b, order, root = _build_aac(lo, hi, np.asarray(wl), np.asarray(wh))
        b = _normalize_aac(b, root)
    else:
        b, order = _build_topdown(lo, hi, split_method)
    info(f"BVH: {len(b.lo)} nodes over {n} prims ({split_method})")
    return BVH(np.stack(b.lo).astype(np.float32), np.stack(b.hi).astype(np.float32),
               np.asarray(b.meta, np.int32), np.asarray(order, np.int32))


def _native_build(lo, hi, split_method) -> Optional[BVH]:
    """The native builder's tree, or None (after one warning a process
    that names the failure) when it is unavailable or returns no nodes."""
    global _native_warned
    try:
        lib = _load_native()
    except PbrtError as e:
        why = str(e)
    else:
        n = len(lo)
        max_nodes = max(16, 4 * n)
        node_lo = np.zeros((max_nodes, 3), np.float32)
        node_hi = np.zeros((max_nodes, 3), np.float32)
        meta = np.zeros((max_nodes, 3), np.int32)
        order = np.zeros(n, np.int32)
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        cnt = lib.pbrt_build_bvh(
            lo.ctypes.data_as(fp), hi.ctypes.data_as(fp), n,
            {"sah": 0, "middle": 1, "equal": 2, "aac": 3}[split_method],
            node_lo.ctypes.data_as(fp), node_hi.ctypes.data_as(fp),
            meta.ctypes.data_as(ip), order.ctypes.data_as(ip), max_nodes,
        )
        if cnt > 0:
            info(f"BVH[native]: {cnt} nodes over {n} prims ({split_method})")
            return BVH(node_lo[:cnt], node_hi[:cnt], meta[:cnt], order)
        why = f"the native BVH build returned {cnt} nodes over {n} prims"
    if not _native_warned:
        _native_warned = True
        warning(f"building BVHs with the Python builders, which are much slower on large "
                f"scenes: {why}")
    return None


# ---------------------------------------------------------------------------
# The Python builders (reference bvh.py _build_topdown, _build_aac): the
# same NumPy operations in the same order and dtypes, so the trees are
# array-identical to the reference's Python trees

def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])


class _Builder:
    """Flattens during build: first child adjacent, second child indexed
    (reference bvh.cpp flattenBVHTree :559)."""

    def __init__(self):
        self.lo, self.hi, self.meta = [], [], []

    def add_node(self):
        self.lo.append(None)
        self.hi.append(None)
        self.meta.append(None)
        return len(self.lo) - 1

    def set_leaf(self, idx, lo, hi, first, count):
        self.lo[idx], self.hi[idx] = lo, hi
        self.meta[idx] = (first, count, 0)

    def set_interior(self, idx, lo, hi, second_child, axis):
        self.lo[idx], self.hi[idx] = lo, hi
        self.meta[idx] = (second_child, 0, axis)


def _deep_recursion(fn, limit: int):
    """fn() with the recursion limit raised to at least `limit`."""
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, limit))
    try:
        return fn()
    finally:
        sys.setrecursionlimit(old)


def _build_topdown(lo, hi, method: str):
    """SAH (12 buckets) / middle / equal top-down build -> (builder, order)."""
    n = len(lo)
    cent = 0.5 * (lo + hi)
    b = _Builder()
    order: list = []

    def leaf(node, nlo, nhi, idx_arr):
        b.set_leaf(node, nlo, nhi, len(order), len(idx_arr))
        order.extend(idx_arr.tolist())
        return node

    def halves(idx_arr, c, axis):
        half = len(idx_arr) // 2
        part = np.argpartition(c[:, axis], half)
        return idx_arr[part[:half]], idx_arr[part[half:]]

    def recurse(idx_arr) -> int:
        node = b.add_node()
        nlo = lo[idx_arr].min(0)
        nhi = hi[idx_arr].max(0)
        if len(idx_arr) <= LEAF_MAX:
            return leaf(node, nlo, nhi, idx_arr)
        c = cent[idx_arr]
        clo, chi = c.min(0), c.max(0)
        axis = int(np.argmax(chi - clo))
        if chi[axis] - clo[axis] < 1e-12:
            return leaf(node, nlo, nhi, idx_arr)
        if method == "middle":
            mask = c[:, axis] < 0.5 * (clo[axis] + chi[axis])
            if mask.all() or not mask.any():
                left, right = halves(idx_arr, c, axis)
            else:
                left, right = idx_arr[mask], idx_arr[~mask]
        elif method == "equal":
            left, right = halves(idx_arr, c, axis)
        else:  # sah, 12 buckets (reference bvh.cpp:476 region)
            NB = 12
            t = (c[:, axis] - clo[axis]) / max(chi[axis] - clo[axis], 1e-12)
            bk = np.minimum((t * NB).astype(np.int32), NB - 1)
            blo = np.full((NB, 3), np.inf)      # float64, as in the reference
            bhi = np.full((NB, 3), -np.inf)
            cnt = np.zeros(NB, np.int64)
            for bi in range(NB):
                m = bk == bi
                if m.any():
                    cnt[bi] = m.sum()
                    blo[bi] = lo[idx_arr[m]].min(0)
                    bhi[bi] = hi[idx_arr[m]].max(0)
            cost = np.full(NB - 1, np.inf)
            for split in range(NB - 1):
                cl = cnt[: split + 1].sum()
                cr = cnt[split + 1:].sum()
                if cl == 0 or cr == 0:
                    continue
                l_lo = blo[: split + 1].min(0)
                l_hi = bhi[: split + 1].max(0)
                r_lo = blo[split + 1:].min(0)
                r_hi = bhi[split + 1:].max(0)
                cost[split] = 0.125 + (
                    cl * _surface_area(l_lo, l_hi) + cr * _surface_area(r_lo, r_hi)
                ) / max(_surface_area(nlo, nhi), 1e-20)
            best = int(np.argmin(cost))
            # always true here (len > LEAF_MAX): the reference's leaf by cost is unreachable
            mask = bk <= best
            if mask.all() or not mask.any():
                left, right = halves(idx_arr, c, axis)
            else:
                left, right = idx_arr[mask], idx_arr[~mask]
        recurse(left)
        second = recurse(right)
        b.set_interior(node, nlo, nhi, second, axis)
        return node

    _deep_recursion(lambda: recurse(np.arange(n)), 10000)
    return b, order


# --- AAC (student mode, reference bvh.cpp:258-389) -------------------------

_AAC_DELTA = 4
_AAC_ALPHA = 0.3
_AAC_C = 0.5 * _AAC_DELTA ** 0.7


def _aac_f(x: int) -> int:
    return max(1, int(np.ceil(_AAC_C * x ** _AAC_ALPHA)))


def _morton30(cent, world_lo, world_hi):
    """30-bit Morton codes via magic-bits interleave (bvh.cpp:47-78), in
    NumPy uint64."""
    t = (cent - world_lo) / np.maximum(world_hi - world_lo, 1e-12)
    q = np.clip((t * 1024.0).astype(np.uint64), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
            | (spread(q[:, 2]) << np.uint64(2)))


@dataclass
class _Cluster:
    lo: np.ndarray
    hi: np.ndarray
    node: int  # builder node index (already emitted subtree), or -1 for leaf prim
    prim: int  # prim id when a raw leaf


def _aac_combine(b: _Builder, order: list, clusters, target: int):
    """Greedy closest-pair merging down to `target` clusters (reference
    bvh.cpp CombineClusters :279-389): each step merges the pair of least
    union surface area, the first in (i, j) order on ties. The
    reference's double loop, as one array of every pair's area a step
    (the same float32 operations, so the same picks). Merged interiors
    name both children explicitly, (-a - 2, -c - 2, 0), for
    _normalize_aac."""
    cl = list(clusters)
    if len(cl) <= target:
        return cl
    los = np.stack([c.lo for c in cl])
    his = np.stack([c.hi for c in cl])
    while len(cl) > target:
        k = len(cl)
        sa = _surface_area(np.minimum(los[:, None], los[None]),
                           np.maximum(his[:, None], his[None]))
        # the reference takes a pair i < j only when its area is < the best so far
        sa = np.where(np.triu(np.ones((k, k), bool), 1) & ~np.isnan(sa), sa, np.inf)
        i, j = divmod(int(np.argmin(sa)), k)
        a, c = cl[i], cl[j]
        node = b.add_node()
        for child in (a, c):
            if child.node < 0:
                leaf = b.add_node()
                b.set_leaf(leaf, child.lo, child.hi, len(order), 1)
                order.append(child.prim)
                child.node = leaf
        u_lo = np.minimum(a.lo, c.lo)
        u_hi = np.maximum(a.hi, c.hi)
        b.lo[node], b.hi[node] = u_lo, u_hi
        b.meta[node] = (-a.node - 2, -c.node - 2, 0)
        cl.pop(j)
        cl[i] = _Cluster(u_lo, u_hi, node, -1)
        los, his = np.delete(los, j, 0), np.delete(his, j, 0)
        los[i], his[i] = u_lo, u_hi
    return cl


def _build_aac(lo, hi, world_lo, world_hi):
    """AAC build over Morton codes in the scene's bounds -> (builder,
    order, root); the builder holds explicit-children interiors until
    _normalize_aac."""
    n = len(lo)
    codes = _morton30(0.5 * (lo + hi), world_lo, world_hi)
    sort = np.argsort(codes, kind="stable")
    codes_s = codes[sort]
    b = _Builder()
    order: list = []

    def prims(s, e):
        return [_Cluster(lo[sort[i]], hi[sort[i]], -1, int(sort[i])) for i in range(s, e)]

    def build_range(s, e, bit) -> list:
        if e - s <= _AAC_DELTA:
            return _aac_combine(b, order, prims(s, e), _aac_f(_AAC_DELTA))
        if bit < 0:
            return _aac_combine(b, order, prims(s, e), _aac_f(e - s))
        # binary search for the bit boundary (bvh.cpp:258-277)
        seg = codes_s[s:e] & (np.uint64(1) << np.uint64(bit))
        split = s + int(np.searchsorted(seg, np.uint64(1)))
        if split == s or split == e:
            return build_range(s, e, bit - 1)
        left = build_range(s, split, bit - 1)
        right = build_range(split, e, bit - 1)
        return _aac_combine(b, order, left + right, _aac_f(e - s))

    root = _deep_recursion(
        lambda: _aac_combine(b, order, build_range(0, n, 29), 1), 10000)[0]
    if root.node < 0:  # single-prim scene
        leaf = b.add_node()
        b.set_leaf(leaf, root.lo, root.hi, len(order), 1)
        order.append(root.prim)
        root.node = leaf
    return b, order, root.node


def _normalize_aac(b: _Builder, root: int) -> _Builder:
    """Re-emit AAC's explicit-children nodes into the linear
    first-child-adjacent layout, depth first."""
    nb = _Builder()

    def emit(i) -> int:
        me = nb.add_node()
        nb.lo[me], nb.hi[me] = b.lo[i], b.hi[i]
        m = b.meta[i]
        if m[0] <= -2:  # explicit interior
            emit(-m[0] - 2)
            nb.meta[me] = (emit(-m[1] - 2), 0, 0)
        else:  # leaf
            nb.meta[me] = (m[0], m[1], m[2])
        return me

    _deep_recursion(lambda: emit(root), 100000)
    return nb


def bvh_to(bvh: BVH, device) -> BVH:
    """The host tree as device tensors."""
    return BVH(torch.as_tensor(bvh.node_lo, device=device),
               torch.as_tensor(bvh.node_hi, device=device),
               torch.as_tensor(bvh.node_meta, dtype=torch.int64, device=device),
               torch.as_tensor(bvh.prim_ids, dtype=torch.int64, device=device))


# ---------------------------------------------------------------------------
# Device traversal of the binary tree (reference bvh.py t_pass_bvh)

def _leaf_prims_t(geom: SceneGeom, prim_ids, o, d, tmin, tmax, time):
    """Candidate t of up to LEAF_MAX gathered prims per ray, at each
    ray's time. prim_ids: [R, K] global ids (-1 = none). -> (t [R, K],
    valid [R, K])."""
    T = geom.n_tris
    dev = o.device
    is_tri = (prim_ids >= 0) & (prim_ids < T)
    tb = torch.full(prim_ids.shape, BIG, device=dev)
    vb = torch.zeros(prim_ids.shape, dtype=torch.bool, device=dev)
    if T > 0:
        tri_idx = torch.clamp(torch.where(is_tri, prim_ids, 0), 0, T - 1)
        v0, e1, e2 = geom.tri_at(tri_idx, time[:, None])
        t, v = mt_t(*(x[..., i] for x in (v0, e1, e2) for i in range(3)),
                    *(o[:, None, i] for i in range(3)), *(d[:, None, i] for i in range(3)),
                    tmin[:, None], tmax[:, None])
        tb = torch.where(is_tri & v, t, tb)
        vb = vb | (is_tri & v)
    if geom.n_quads > 0:
        q_idx = torch.clamp(torch.where(prim_ids >= T, prim_ids - T, 0), 0, geom.n_quads - 1)
        _, w2o = geom.quad_xforms_at(q_idx, time[:, None])
        oo = xform_point_affine(w2o, o[:, None])
        od = xform_vector(w2o, d[:, None])
        t, v = quad_candidates(geom.quad_type[q_idx], geom.quad_params[q_idx], oo, od,
                               tmin[:, None], tmax[:, None], present=geom.quad_present)
        is_q = prim_ids >= T
        tb = torch.where(is_q & v, t, tb)
        vb = vb | (is_q & v)
    return tb, vb


def min_first(x):
    """(min, index of its first occurrence) along the last axis, on
    every device (the JAX package's argmin), for the grid and kd-tree
    walks."""
    m = torch.amin(x, -1)
    cols = torch.arange(x.shape[-1], device=x.device)
    return m, torch.amin(torch.where(x == m[..., None], cols, x.shape[-1]), -1)


def t_pass_bvh(bvh: BVH, geom: SceneGeom, ray, any_hit: bool = False):
    """Per-ray short-stack walk of the binary tree, all rays in lockstep
    (reference bvh.cpp:585-687 Intersect). Returns (t [R], prim [R]).

    The reference's rules, each of which decides which prim wins: the
    slab test uses 1/where(|d| > 1e-20, d, 1e-20) and accepts a box at
    tn <= tf * 1.0001; a leaf takes its first least candidate and must
    be strictly nearer than the best so far; children are pushed far
    first (near popped first) by the ray's sign on the split axis, and
    a push past MAX_DEPTH is silently dropped; an any-hit walk ends
    only once every ray has hit or emptied its stack. The loop ends on
    the host, which reads the stop condition every WALK_CHECK_EVERY
    iterations (one host sync each); once it holds on the device, every
    later iteration is a no-op, so the result is the reference's
    exactly."""
    R = ray.o.shape[0]
    dev = ray.o.device
    o, d = ray.o, ray.d
    big = torch.full((), BIG, device=dev)
    inv_d = 1.0 / torch.where(torch.abs(d) > 1e-20, d, torch.full((), 1e-20, device=dev))
    neg = inv_d < 0.0
    t_best = torch.where(torch.isfinite(ray.tmax), ray.tmax, big)
    prim_best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    stack = torch.zeros((R, MAX_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones((R,), dtype=torch.int64, device=dev)   # the root pre-pushed
    stopped = torch.zeros((), dtype=torch.bool, device=dev)
    iters = torch.zeros((), dtype=torch.int64, device=dev)
    P = bvh.prim_ids.shape[0]
    k = torch.arange(LEAF_MAX, device=dev)
    minus1 = torch.full((), -1, dtype=torch.int64, device=dev)

    def push(stack, sp, node, can):
        slot = torch.clamp(sp, max=MAX_DEPTH - 1)[:, None]
        stack.scatter_(1, slot, torch.where(can, node, stack.gather(1, slot)[:, 0])[:, None])
        return torch.where(can, sp + 1, sp)

    n = 0
    while True:
        if n % WALK_CHECK_EVERY == 0:
            with probes.scope("sync/walk_stop"):
                going = bool((~stopped) & (sp > 0).any())
            if not going:
                break
        n += 1
        has = (sp > 0) & ~stopped
        iters = iters + has.any()
        top = torch.clamp(sp - 1, min=0)
        node = torch.where(has, stack.gather(1, top[:, None])[:, 0], 0)
        sp2 = torch.where(has, sp - 1, sp)
        lo, hi, m = bvh.node_lo[node], bvh.node_hi[node], bvh.node_meta[node]
        # slab test against the best t so far
        t_lo = (lo - o) * inv_d
        t_hi = (hi - o) * inv_d
        tn = torch.maximum(torch.amax(torch.minimum(t_lo, t_hi), -1), ray.tmin)
        tf = torch.minimum(torch.amin(torch.maximum(t_lo, t_hi), -1), t_best)
        box_hit = has & (tn <= tf * 1.0001)
        is_leaf = m[:, 1] > 0
        # leaf: up to LEAF_MAX prims
        in_range = (k[None, :] < m[:, 1:2]) & (box_hit & is_leaf)[:, None]
        pidx = torch.clamp(m[:, 0:1] + k[None, :], 0, max(P - 1, 0))
        gids = torch.where(in_range, bvh.prim_ids[pidx], minus1)
        t_c, v_c = _leaf_prims_t(geom, gids, o, d, ray.tmin, t_best, ray.time)
        t_c = torch.where(v_c, t_c, big)
        t_leaf = torch.amin(t_c, -1)
        j = torch.amin(torch.where(t_c == t_leaf[:, None], k, LEAF_MAX), -1)
        g_leaf = gids.gather(1, torch.clamp(j, max=LEAF_MAX - 1)[:, None])[:, 0]
        better = box_hit & is_leaf & (t_leaf < t_best)
        t_best = torch.where(better, t_leaf, t_best)
        prim_best = torch.where(better, g_leaf, prim_best)
        # interior: push far, then near (near is popped first)
        neg_ax = neg.gather(1, torch.clamp(m[:, 2:3], 0, 2))[:, 0]
        c1, c2 = node + 1, m[:, 0]
        near = torch.where(neg_ax, c2, c1)
        far = torch.where(neg_ax, c1, c2)
        do_push = box_hit & ~is_leaf
        sp3 = push(stack, sp2, far, do_push & (sp2 < MAX_DEPTH))
        sp3 = push(stack, sp3, near, do_push & (sp3 < MAX_DEPTH))
        sp = sp3
        if any_hit:
            stopped = stopped | torch.all((prim_best >= 0) | (sp == 0))
    walk_stats["traversals"] += 1
    with probes.scope("sync/walk_iters"):
        walk_stats["iterations"] += int(iters)
    return torch.where(prim_best >= 0, t_best, big), prim_best


class BvhScene(NamedTuple):
    """Geometry + acceleration: the wide packet pipeline (K2), the
    binary-BVH walk, the flat t-pass (K1), or the block scan at ray
    time, then the quadric fold (after all but the walk)."""

    geom: SceneGeom
    tri_soa: object = None   # ops.intersect_cuda.TriSoA
    wide: object = None      # accel.wide_bvh.WideBVH
    bvh: BVH = None          # the binary tree on the device

    def _t_pass(self, ray: Ray, any_hit: bool = False, coherent: bool = False):
        if self.bvh is not None:
            return t_pass_bvh(self.bvh, self.geom, ray, any_hit=any_hit)
        if self.wide is not None:
            from pbrt_tpu_torch.ops.bvh_cuda import wide_t_pass

            t, prim = wide_t_pass(self.wide, ray.o, ray.d, ray.tmin, ray.tmax,
                                  any_hit=any_hit, coherent=coherent)
        elif self.tri_soa is not None:
            from pbrt_tpu_torch.ops.intersect_cuda import tri_t_pass

            t, prim = tri_t_pass(self.tri_soa, ray.o, ray.d, ray.tmin, ray.tmax)
        elif self.geom.n_tris > 0:   # a motion scene: the block scan at ray time
            t, prim = intersect.t_pass_brute(self.geom, ray)
        else:  # no triangles: empty accumulators (quad_t_pass starts from tmax)
            t = torch.full(ray.tmin.shape, BIG, device=ray.o.device)
            prim = torch.full(ray.tmin.shape, -1, dtype=torch.int64, device=ray.o.device)
        if self.geom.n_quads > 0:
            t, prim = quad_t_pass(self.geom, ray, t, prim)
        return t, prim

    def intersect(self, ray: Ray, coherent: bool = False):
        t, prim = self._t_pass(ray, coherent=coherent)
        return reconstruct(self.geom, ray, t, prim)

    def intersect_p(self, ray: Ray, coherent: bool = False):
        _, prim = self._t_pass(ray, any_hit=True, coherent=coherent)
        return prim >= 0


def make_accel(geom: SceneGeom, split_method: str = "sah", force: str = "") -> BvhScene:
    """Pick the acceleration strategy for a compiled scene, as the
    reference's make_accel does on its TPU (pbrt_tpu/accel/bvh.py
    :591-622): wide (K2) for static scenes with >= WIDE_THRESHOLD
    triangles (any triangles with force="wide"); the binary-BVH walk
    above BVH_THRESHOLD primitives or with force="bvh"; else the flat
    t-pass (K1) for static scenes with triangles and the block scan at
    ray time (t_pass_brute) for motion scenes. force="flat"
    (Accelerator "none") skips the wide and binary trees. Motion scenes
    reach neither kernel: that is the reference's routing."""
    n_prims = geom.n_tris + geom.n_quads
    dev = geom.tri_v0.device
    world = (geom.world_lo.cpu().numpy(), geom.world_hi.cpu().numpy())   # AAC's Morton grid
    if (force in ("", "wide") and not geom.has_motion
            and geom.n_tris >= (1 if force == "wide" else WIDE_THRESHOLD)):
        from pbrt_tpu_torch.accel.wide_bvh import build_wide_bvh

        v0, e1, e2 = (x.cpu().numpy() for x in (geom.tri_v0, geom.tri_e1, geom.tri_e2))
        quads = (quad_bounds(geom.quad_o2w.cpu().numpy(), geom.quad_params.cpu().numpy())
                 if geom.n_quads > 0 else None)
        with probes.scope("scene/bvh_build"):
            narrow = build_bvh(v0, e1, e2, split_method, quads, world)
        with probes.scope("scene/wide_bvh"):
            wide = build_wide_bvh(narrow, v0, e1, e2, dev)
        return BvhScene(geom=geom, wide=wide)
    if (force == "bvh" or (force != "flat" and n_prims > BVH_THRESHOLD)) and n_prims > 0:
        with probes.scope("scene/bvh_build"):
            tree = build_bvh_bounds(*prim_bounds(geom), split_method, world)
        return BvhScene(geom=geom, bvh=bvh_to(tree, dev))
    if geom.n_tris == 0 or geom.has_motion:
        return BvhScene(geom=geom)
    from pbrt_tpu_torch.ops.intersect_cuda import TriSoA

    return BvhScene(geom=geom, tri_soa=TriSoA(geom.tri_v0, geom.tri_e1, geom.tri_e2))
