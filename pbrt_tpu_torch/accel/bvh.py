"""BVH accelerator: host build, and the t-pass dispatch of the main path.

Port of the parts of pbrt_tpu/accel/bvh.py the main path runs. The
binary tree comes from the same native C++ builder as the reference
(pbrt_tpu/native/bvh_builder.cpp, read by path and compiled with g++
into the port's build directory), then accel/wide_bvh.py collapses it
into 128-triangle leaf blocks. The dispatch follows the reference's TPU
branch: scenes with at least WIDE_THRESHOLD triangles use the packet
pipeline (ops/bvh_cuda.py, kernel K2), smaller ones the flat t-pass
(ops/intersect_cuda.py, kernel K1).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import NamedTuple, Optional

import numpy as np

from pbrt_tpu_torch.core.error import PbrtError, info
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.accel.intersect import SceneGeom, reconstruct

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NATIVE_SRC = os.path.join(_REPO, "pbrt_tpu", "native", "bvh_builder.cpp")
_BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "_build")
WIDE_THRESHOLD = 8192
_LOCK = threading.Lock()
_LIB = None


class BVH(NamedTuple):
    """Flattened binary tree (NumPy, host): first child adjacent."""

    node_lo: np.ndarray    # [N, 3]
    node_hi: np.ndarray    # [N, 3]
    node_meta: np.ndarray  # [N, 3] int32: (second_child|offset, n_prims, axis)
    prim_ids: np.ndarray   # [P] int32 prim ids (leaf order)


def _load_native():
    """Compile the shared C++ builder with g++ (same flags as the
    reference's pbrt_tpu/native loader) and load it with ctypes."""
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


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              split_method: str = "sah") -> Optional[BVH]:
    """Binary BVH over triangles (v0, e1, e2) [T, 3] float32."""
    lo, hi = _tri_bounds(v0, e1, e2)
    n = len(lo)
    if n == 0:
        return None
    if split_method not in ("sah", "middle", "equal", "aac"):
        raise PbrtError(f'BVH split method "{split_method}" unknown')
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
    triangle-heavy scenes, the flat t-pass (K1) otherwise."""

    geom: SceneGeom
    tri_soa: object = None   # ops.intersect_cuda.TriSoA
    wide: object = None      # accel.wide_bvh.WideBVH

    def _t_pass(self, ray: Ray, any_hit: bool = False, coherent: bool = False):
        if self.wide is not None:
            from pbrt_tpu_torch.ops.bvh_cuda import wide_t_pass

            return wide_t_pass(self.wide, ray.o, ray.d, ray.tmin, ray.tmax,
                               any_hit=any_hit, coherent=coherent)
        from pbrt_tpu_torch.ops.intersect_cuda import tri_t_pass

        return tri_t_pass(self.tri_soa, ray.o, ray.d, ray.tmin, ray.tmax)

    def intersect(self, ray: Ray, coherent: bool = False):
        t, prim = self._t_pass(ray, coherent=coherent)
        return reconstruct(self.geom, ray, t, prim)

    def intersect_p(self, ray: Ray, coherent: bool = False):
        _, prim = self._t_pass(ray, any_hit=True, coherent=coherent)
        return prim >= 0


def make_accel(geom: SceneGeom, split_method: str = "sah", force: str = "") -> BvhScene:
    """Pick the acceleration strategy for a compiled scene (reference
    make_accel, TPU branch): wide for >= WIDE_THRESHOLD triangles unless
    `force == "flat"` (Accelerator "none"), flat otherwise."""
    if force != "flat" and geom.n_tris >= WIDE_THRESHOLD:
        from pbrt_tpu_torch.accel.wide_bvh import build_wide_bvh

        v0, e1, e2 = (x.cpu().numpy() for x in (geom.tri_v0, geom.tri_e1, geom.tri_e2))
        narrow = build_bvh(v0, e1, e2, split_method)
        wide = build_wide_bvh(narrow, v0, e1, e2, geom.tri_v0.device)
        return BvhScene(geom=geom, wide=wide)
    from pbrt_tpu_torch.ops.intersect_cuda import TriSoA

    return BvhScene(geom=geom, tri_soa=TriSoA(geom.tri_v0, geom.tri_e1, geom.tri_e2))
