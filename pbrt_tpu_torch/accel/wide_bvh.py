"""Wide-leaf BVH for the packet t-pass (K2, ops/bvh_cuda.py).

Port of pbrt_tpu/accel/wide_bvh.py: the binary SAH tree from
accel/bvh.py is collapsed on the host (NumPy) into leaves of up to
LEAF_W=128 triangles, each one 128-column block of a component-major
[16, P'] triangle table (rows 0-8 = v0, e1, e2). Ray packets of TILE
rays are culled against the leaf-block boxes and swept block by block.
"""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

LEAF_W = 128          # triangles per wide leaf (one kernel block)
TILE = 1024           # rays per packet
MAX_L = 64            # leaf-list slots per tile per wave


class WideBVH(NamedTuple):
    block_lo: torch.Tensor   # [B, 3] f32 leaf-block bounds
    block_hi: torch.Tensor   # [B, 3] f32
    tris16: torch.Tensor     # [16, P'] f32 component-major (v0,e1,e2 rows 0-8)
    prim_map: torch.Tensor   # [P'] i64 padded slot -> global prim id (-1 pad)
    world_lo: torch.Tensor   # [3] f32 root bounds (coherence-sort domain)
    world_hi: torch.Tensor   # [3] f32
    n_blocks: int            # number of real leaf blocks (sentinel block = n_blocks)


def _subtree_counts(meta: np.ndarray) -> np.ndarray:
    """Prim count per node of a flattened first-child-adjacent tree."""
    n = len(meta)
    cnt = np.zeros(n, np.int64)
    # reverse order: children always have larger indices than parents
    for i in range(n - 1, -1, -1):
        if meta[i, 1] > 0:
            cnt[i] = meta[i, 1]
        else:
            cnt[i] = cnt[i + 1] + cnt[meta[i, 0]]
    return cnt


def _gather_subtree_prims(meta, order, root) -> list:
    """All prim ids under `root` (iterative DFS)."""
    out, stack = [], [root]
    while stack:
        i = stack.pop()
        if meta[i, 1] > 0:
            out.extend(order[meta[i, 0]: meta[i, 0] + meta[i, 1]])
        else:
            stack.append(meta[i, 0])
            stack.append(i + 1)
    return out


def build_wide_bvh(bvh, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                   device) -> Optional[WideBVH]:
    """Collapse a narrow BVH (accel/bvh.py BVH, NumPy arrays) over the
    triangles (v0, e1, e2) [T, 3] into the wide-leaf kernel layout."""
    node_lo, node_hi, meta, order = bvh
    T = len(v0)
    if T == 0:
        return None
    cnt = _subtree_counts(meta)

    w_lo, w_hi, w_meta = [], [], []
    leaf_prims: list = []   # per-leaf prim-id lists

    def emit(node_i):
        w_lo.append(node_lo[node_i])
        w_hi.append(node_hi[node_i])
        w_meta.append([0, 0, int(meta[node_i, 2])])
        return len(w_lo) - 1

    def dfs(node_i) -> int:
        me = emit(node_i)
        if cnt[node_i] <= LEAF_W:
            prims = _gather_subtree_prims(meta, order, node_i)
            w_meta[me][0] = len(leaf_prims)       # leaf block id
            w_meta[me][1] = len(prims)            # count > 0 -> leaf
            leaf_prims.append(prims)
            return me
        dfs(node_i + 1)
        second = dfs(meta[node_i, 0])
        w_meta[me][0] = second
        w_meta[me][1] = 0
        return me

    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 100000))
    try:
        dfs(0)
    finally:
        sys.setrecursionlimit(old)

    n_blocks = len(leaf_prims)
    Pp = (n_blocks + 1) * LEAF_W  # +1 sentinel (all-degenerate) block
    tris16 = np.zeros((16, Pp), np.float32)
    prim_map = np.full(Pp, -1, np.int64)
    for b, prims in enumerate(leaf_prims):
        ids = np.asarray([p for p in prims if p < T], np.int64)
        s = b * LEAF_W
        k = len(ids)
        if k:
            tris16[0:3, s:s + k] = v0[ids].T
            tris16[3:6, s:s + k] = e1[ids].T
            tris16[6:9, s:s + k] = e2[ids].T
            prim_map[s:s + k] = ids
    w_meta_a = np.asarray(w_meta, np.int32)
    lo_a = np.stack(w_lo).astype(np.float32)
    hi_a = np.stack(w_hi).astype(np.float32)
    is_leaf = w_meta_a[:, 1] > 0
    blk = w_meta_a[is_leaf, 0]
    block_lo = np.zeros((n_blocks, 3), np.float32)
    block_hi = np.zeros((n_blocks, 3), np.float32)
    block_lo[blk] = lo_a[is_leaf]
    block_hi[blk] = hi_a[is_leaf]

    def dev(x):
        return torch.as_tensor(x, device=device).contiguous()

    return WideBVH(block_lo=dev(block_lo), block_hi=dev(block_hi),
                   tris16=dev(tris16), prim_map=dev(prim_map),
                   world_lo=dev(lo_a[0]), world_hi=dev(hi_a[0]),
                   n_blocks=n_blocks)
