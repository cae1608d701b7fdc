"""Host build seconds of the port's grid and kd-tree accelerators.

Times pbrt_tpu_torch/accel/grid.py build_grid_arrays and
pbrt_tpu_torch/accel/kdtree.py build_kdtree_arrays (default parameters)
on the CPU over the layout of chip_smoke.py's bench scene (an n x n UV
sphere over a two-triangle floor, 2 n^2 + 2 triangles) for several n,
and on chip_smoke.py's small scene (7,204 triangles). chip_smoke.py's
[27] renders under the kd-tree the largest of these layouts whose build
stays within 30 s. Prints one JSON line per scene.

    python scripts/port_accel_build_times.py [n ...]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pbrt_tpu_torch.accel.bvh import _tri_bounds  # noqa: E402
from pbrt_tpu_torch.accel.grid import build_grid_arrays  # noqa: E402
from pbrt_tpu_torch.accel.kdtree import build_kdtree_arrays  # noqa: E402


def bench_tris(n):
    P, idx = cs.uv_sphere(n, n, 1.0, (0.0, 0.4, 0.0))
    return np.concatenate([P[idx.reshape(-1, 3)], cs.FLOOR[cs.FLOOR_IDX.reshape(-1, 3)]])


def small_tris():
    quad = np.array([[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]], np.float32)
    floor = cs.FLOOR.copy()
    floor[:, 1] = 0.0
    tris = [quad[cs.FLOOR_IDX.reshape(-1, 3)]]
    for k in range(4):
        P, idx = cs.uv_sphere(30, 30, 0.5, (-1.8 + 1.2 * k, 0.5, 0.0))
        tris.append(P[idx.reshape(-1, 3)])
    return np.concatenate(tris + [floor[cs.FLOOR_IDX.reshape(-1, 3)]])


def main(ns):
    for name, t in [("small", small_tris())] + [(f"bench{n}", bench_tris(n)) for n in ns]:
        lo, hi = _tri_bounds(t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        t0 = time.perf_counter()
        g = build_grid_arrays(lo, hi)
        t1 = time.perf_counter()
        kd = build_kdtree_arrays(lo, hi)
        t2 = time.perf_counter()
        print(json.dumps({"scene": name, "triangles": len(t), "grid_s": t1 - t0,
                          "grid_refs": len(g["voxel_prims"]), "kd_s": t2 - t1,
                          "kd_nodes": len(kd["node_meta"])}), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [60, 80, 88, 100])
