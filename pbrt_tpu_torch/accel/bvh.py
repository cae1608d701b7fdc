"""BVH accelerator: host build, and the t-pass dispatch of the main path.

Port of the parts of pbrt_tpu/accel/bvh.py the main path runs. The
binary tree comes from the port's own copy of the reference's native
C++ builder (csrc/bvh_builder.cpp, byte-identical to the reference's,
so both packages build the same tree), compiled with g++ into the
port's build directory, over the reference's primitive bounds
(triangles, then quadric boxes); accel/wide_bvh.py then collapses it
into 128-triangle leaf blocks, dropping the quadrics from the leaves.
The dispatch follows the reference's TPU branch: scenes with at least
WIDE_THRESHOLD triangles use the packet pipeline (ops/bvh_cuda.py,
kernel K2), smaller ones the flat t-pass (ops/intersect_cuda.py, kernel
K1); the quadrics are then folded into the triangles' result
(accel/intersect.py quad_t_pass). A scene without triangles folds its
quadrics into empty accumulators and runs no triangle t-pass.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core.error import PbrtError, info, warning
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.core.transform import xform_point_affine
from pbrt_tpu_torch.accel.intersect import BIG, SceneGeom, quad_t_pass, reconstruct

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_SRC = os.path.join(_PKG, "csrc", "bvh_builder.cpp")
_BUILD_ROOT = os.path.join(_PKG, "_build")
WIDE_THRESHOLD = 8192
BVH_THRESHOLD = 32768   # primitives above which the reference traverses a binary BVH
_LOCK = threading.Lock()
_LIB = None


class BVH(NamedTuple):
    """Flattened binary tree (NumPy, host): first child adjacent."""

    node_lo: np.ndarray    # [N, 3]
    node_hi: np.ndarray    # [N, 3]
    node_meta: np.ndarray  # [N, 3] int32: (second_child|offset, n_prims, axis)
    prim_ids: np.ndarray   # [P] int32 prim ids (leaf order)


def _load_native():
    """Compile the C++ builder with g++ (the flags of the reference's
    native loader) and load it with ctypes."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
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
        _LIB = lib
        return lib


def _tri_bounds(v0, e1, e2):
    p1, p2 = v0 + e1, v0 + e2
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    return lo.astype(np.float32), hi.astype(np.float32)


def quad_bounds(quad_o2w: np.ndarray, quad_params: np.ndarray):
    """World boxes [Q, 3] of the quadrics (the reference's _prim_bounds:
    the object box [-r, r]^2 x [zmin, zmax] through o2w, corner by
    corner)."""
    lo_q = np.zeros((len(quad_params), 3), np.float32)
    hi_q = np.zeros((len(quad_params), 3), np.float32)
    for i in range(len(quad_params)):
        r = abs(float(quad_params[i, 0]))
        zmin, zmax = float(quad_params[i, 1]), float(quad_params[i, 2])
        corners = np.array([[x, y, z] for x in (-r, r) for y in (-r, r) for z in (zmin, zmax)])
        wc = xform_point_affine(quad_o2w[i], corners)
        lo_q[i] = wc.min(0)
        hi_q[i] = wc.max(0)
    return lo_q, hi_q


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, split_method: str = "sah",
              quads=None) -> Optional[BVH]:
    """Binary BVH over the triangles (v0, e1, e2) [T, 3] float32, then
    the quadric boxes `quads` = (lo [Q, 3], hi [Q, 3]) if given: prim ids
    T.. are the quadrics, as in the reference. An unknown split method
    warns and builds SAH (the reference's native builder maps it to
    SAH)."""
    lo, hi = _tri_bounds(v0, e1, e2)
    if quads is not None and len(quads[0]):
        lo = np.concatenate([lo, quads[0]]).astype(np.float32)
        hi = np.concatenate([hi, quads[1]]).astype(np.float32)
    n = len(lo)
    if n == 0:
        return None
    if split_method not in ("sah", "middle", "equal", "aac"):
        warning(f'BVH split method "{split_method}" unknown; using "sah"')
        split_method = "sah"
    lib = _load_native()
    method_id = {"sah": 0, "middle": 1, "equal": 2, "aac": 3}[split_method]
    max_nodes = max(16, 4 * n)
    lo_c = np.ascontiguousarray(lo, np.float32)
    hi_c = np.ascontiguousarray(hi, np.float32)
    node_lo = np.zeros((max_nodes, 3), np.float32)
    node_hi = np.zeros((max_nodes, 3), np.float32)
    meta = np.zeros((max_nodes, 3), np.int32)
    order = np.zeros(n, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    cnt = lib.pbrt_build_bvh(
        lo_c.ctypes.data_as(fp), hi_c.ctypes.data_as(fp), n, method_id,
        node_lo.ctypes.data_as(fp), node_hi.ctypes.data_as(fp),
        meta.ctypes.data_as(ip), order.ctypes.data_as(ip), max_nodes,
    )
    if cnt <= 0:
        raise PbrtError("native BVH build failed")
    info(f"BVH[native]: {cnt} nodes over {n} prims ({split_method})")
    return BVH(node_lo[:cnt], node_hi[:cnt], meta[:cnt], order)


class BvhScene(NamedTuple):
    """Geometry + acceleration: the wide packet pipeline (K2) for
    triangle-heavy scenes, the flat t-pass (K1) for other scenes with
    triangles, and the quadric fold after either (or alone)."""

    geom: SceneGeom
    tri_soa: object = None   # ops.intersect_cuda.TriSoA
    wide: object = None      # accel.wide_bvh.WideBVH

    def _t_pass(self, ray: Ray, any_hit: bool = False, coherent: bool = False):
        if self.wide is not None:
            from pbrt_tpu_torch.ops.bvh_cuda import wide_t_pass

            t, prim = wide_t_pass(self.wide, ray.o, ray.d, ray.tmin, ray.tmax,
                                  any_hit=any_hit, coherent=coherent)
        elif self.tri_soa is not None:
            from pbrt_tpu_torch.ops.intersect_cuda import tri_t_pass

            t, prim = tri_t_pass(self.tri_soa, ray.o, ray.d, ray.tmin, ray.tmax)
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
    """Pick the acceleration strategy for a compiled scene (reference
    make_accel, TPU branch): wide for >= WIDE_THRESHOLD triangles unless
    `force == "flat"` (Accelerator "none"), flat otherwise. The
    reference's binary-BVH traversal for more than BVH_THRESHOLD
    triangles and quadrics is not yet ported."""
    n_prims = geom.n_tris + geom.n_quads
    use_wide = force != "flat" and geom.n_tris >= WIDE_THRESHOLD
    if not use_wide and force != "flat" and n_prims > BVH_THRESHOLD:
        raise PbrtError(f"not yet ported: binary BVH traversal (t_pass_bvh) for "
                        f"{n_prims} primitives with fewer than {WIDE_THRESHOLD} triangles")
    if use_wide:
        from pbrt_tpu_torch.accel.wide_bvh import build_wide_bvh

        v0, e1, e2 = (x.cpu().numpy() for x in (geom.tri_v0, geom.tri_e1, geom.tri_e2))
        quads = (quad_bounds(geom.quad_o2w.cpu().numpy(), geom.quad_params.cpu().numpy())
                 if geom.n_quads > 0 else None)
        narrow = build_bvh(v0, e1, e2, split_method, quads)
        return BvhScene(geom=geom, wide=build_wide_bvh(narrow, v0, e1, e2, geom.tri_v0.device))
    if geom.n_tris == 0:
        return BvhScene(geom=geom)
    from pbrt_tpu_torch.ops.intersect_cuda import TriSoA

    return BvhScene(geom=geom, tri_soa=TriSoA(geom.tri_v0, geom.tri_e1, geom.tri_e2))
