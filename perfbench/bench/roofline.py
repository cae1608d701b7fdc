"""Peaks of the card and the work of the renderer's kernels.

A frozen copy of the arithmetic of chip_smoke.py, so that a later change
to the program cannot move the yardstick. A kernel's bound is the larger
of its operations over the float32 peak and its bytes over the memory
bandwidth; its share of the roofline is that bound over its measured
device time.
"""
from __future__ import annotations

PEAK_F32 = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s (data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (data sheet)
MT_FLOPS = 46          # float32 operations of one Moller-Trumbore test
K2_TILE = 1024         # rays a K2 tile
K2_LEAF_W = 128        # triangles a leaf block
K2_BLOCK_BYTES = 9 * K2_LEAF_W * 4     # a leaf block's v0, e1, e2 in float32
K2_RAY_BYTES = 32 + 2 * 8              # a ray (8 floats) and its t / prim in and out


def k2_launch_bound(pairs: int, blocks: int, tiles: int, listed: int, n_tiles: int):
    """(operations seconds, bytes seconds) of one K2 launch: `pairs` real
    (tile, leaf block) pairs of `listed` list positions over `n_tiles`
    tiles, `tiles` of them with pairs, naming `blocks` distinct blocks."""
    nbytes = (blocks * K2_BLOCK_BYTES + tiles * K2_TILE * K2_RAY_BYTES + listed * 4
              + n_tiles * 8)
    return pairs * K2_TILE * K2_LEAF_W * MT_FLOPS / PEAK_F32, nbytes / PEAK_BYTES


def k1_launch_bound(rays: int, live: int, n_tris: int):
    """(operations seconds, bytes seconds) of one K1 launch over its live
    rays (tmin < tmax): each tests every triangle; the bytes are the rays
    (8 floats), the triangles (9 floats) and the t / prim out."""
    nbytes = rays * 8 * 4 + n_tris * 9 * 4 + rays * 8
    return live * n_tris * MT_FLOPS / PEAK_F32, nbytes / PEAK_BYTES


def k2_work(pair_block, start, count, sentinel):
    """One K2 launch's work, without a sync: a device tensor (real pairs,
    distinct leaf blocks, tiles with pairs, listed pairs) and the tiles."""
    import torch

    n = count.sum()
    real = (torch.arange(pair_block.numel(), device=count.device) < n) & (pair_block != sentinel)
    seen = torch.zeros(sentinel + 1, dtype=torch.int64, device=count.device)
    seen.scatter_(0, torch.where(real, pair_block, sentinel).long(), 1)
    return (torch.stack([real.sum(), seen[:sentinel].sum(), (count > 0).sum(), n.long()]),
            count.numel())
