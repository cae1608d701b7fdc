"""K1: the flat ray-triangle t-pass, a CUDA kernel and its plain twin.

Port of pbrt_tpu/ops/intersect_pallas.py. The Pallas TPU kernel
`_tri_kernel` becomes csrc/intersect.cu; the layouts stay the
reference's: rays `[R, 8]` (o, d, tmin, tmax), triangles `[9, T]`
component-major v0/e1/e2 padded to a multiple of 256.

The kernel lists the live rays (tmin < tmax) on the device, sweeps
(slice of live rays, chunk of 256-triangle stages) items over the whole
card, and merges each ray's candidates by the least `pack_keys` key.
`tri_t_pass_chunked` states that decomposition in torch; it equals the
sequential fold of `tri_t_pass_plain` bit for bit.

`tri_t_pass` dispatches on the tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors run `tri_t_pass_plain`, the same
arithmetic in plain torch.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.ops.build import check_cuda, load_kernels, raise_on_launch_error

BIG = 1e30
TB = 256   # triangles per stage (csrc/intersect.cu K1_TB)
KEY_EMPTY = 0x7F7F7F7F7F7F7F7F  # a ray's key before any candidate; above every candidate's

launches = 0  # K1 kernel launches in this process


def _round_up(n, m):
    return (n + m - 1) // m * m


class TriSoA:
    """Component-major triangle table for the kernel: [9, Tpad]."""

    def __init__(self, tri_v0, tri_e1, tri_e2):
        self.n = tri_v0.shape[0]
        Tpad = max(TB, _round_up(self.n, TB))
        data = torch.zeros((9, Tpad), dtype=torch.float32, device=tri_v0.device)
        if self.n:
            data[0:3, : self.n] = tri_v0.T
            data[3:6, : self.n] = tri_e1.T
            data[6:9, : self.n] = tri_e2.T
        # padded lanes: degenerate (all-zero) triangles never hit
        self.tris9 = data.contiguous()


def _stage_min(rays8, tris9, s: int):
    """Per ray, the least t over the triangles of stage s (BIG when none
    is hit) and its index, lowest on ties: ([R] f32, [R] i64)."""
    from pbrt_tpu_torch.accel.intersect import mt_t

    tri = [tris9[c:c + 1, s * TB:(s + 1) * TB] for c in range(9)]
    t, valid = mt_t(*tri, *(rays8[:, i:i + 1] for i in range(8)))
    t_blk, idx = torch.min(torch.where(valid, t, torch.full((), BIG, device=rays8.device)), -1)
    return t_blk, s * TB + idx


def tri_t_pass_plain(rays8, tris9, n_tris: int):
    """Plain torch twin of the kernel: (t [R], prim [R] int32). Stages
    fold in index order with a strict '<'. Only live rays (tmin < tmax)
    are tested, and only the n_tris real triangles: a dead ray or a
    padding triangle yields no candidate, so leaving them out changes
    no bit of the result."""
    R = rays8.shape[0]
    dev = rays8.device
    big = torch.full((), BIG, device=dev)
    live = rays8[:, 6] < rays8[:, 7]
    rays = rays8[live]
    t_best = torch.full((rays.shape[0],), BIG, device=dev)
    p_best = torch.full((rays.shape[0],), -1, dtype=torch.int32, device=dev)
    for s in range(_round_up(n_tris, TB) // TB):
        t_blk, prim = _stage_min(rays, tris9[:, :n_tris], s)
        better = t_blk < t_best
        t_best = torch.where(better, t_blk, t_best)
        p_best = torch.where(better, prim.to(torch.int32), p_best)
    t = torch.full((R,), BIG, device=dev)
    p = torch.full((R,), -1, dtype=torch.int32, device=dev)
    t[live], p[live] = t_best, p_best
    miss = (p < 0) | (p >= n_tris) | (t >= BIG)
    return torch.where(miss, big, t), torch.where(miss, -1, p)


def key_of_t(t):
    """The t part of the t-passes' int64 merge keys (csrc/common.cuh):
    the bits of t made to order as integers in the order of t (-0.0
    taken as +0.0) in the high 32 bits, and in bit 0 whether t was -0.0.
    Each t-pass puts its tie-break in bits 1-31."""
    bits = t.contiguous().view(torch.int32)
    neg_zero = bits == -(1 << 31)
    i = torch.where(neg_zero, 0, bits)
    return ((i ^ ((i >> 31) & 0x7FFFFFFF)).to(torch.int64) << 32) | neg_zero.to(torch.int64)


def t_of_key(keys):
    """The inverse of key_of_t: t, every bit of it."""
    hi = (keys >> 32).to(torch.int32)
    i = hi ^ ((hi >> 31) & 0x7FFFFFFF)
    return torch.where((keys & 1) == 1, torch.full((), -0.0, device=keys.device),
                       i.view(torch.float32))


def pack_keys(t, prim):
    """K1's merge keys of candidates (t f32, prim): key_of_t, then prim.
    A ray's least key is its least t at the lowest prim, the candidate a
    strict '<' fold in index order keeps."""
    return key_of_t(t) | (prim.to(torch.int64) << 1)


def unpack_keys(keys):
    """keys -> (t f32, prim i64); the inverse of pack_keys."""
    return t_of_key(keys), (keys & 0xFFFFFFFF) >> 1


def finish_keys(keys, n_tris: int):
    """The finish of K1 (csrc/intersect.cu k1_finish_kernel): each ray's
    least key -> (t [R], prim [R] int32) with the miss rule."""
    t, prim = unpack_keys(keys)
    miss = (keys == KEY_EMPTY) | (prim >= n_tris) | (t >= BIG)
    return (torch.where(miss, torch.full((), BIG, device=keys.device), t),
            torch.where(miss, -1, prim).to(torch.int32))


def tri_t_pass_chunked(rays8, tris9, n_tris: int, chunk: int, order):
    """Plain torch model of K1's decomposition: (t [R], prim [R] int32).
    Only live rays (tmin < tmax) are tested; the stages are cut into
    chunks of `chunk`; each chunk yields one key per live ray (the least
    of its candidates' keys); the chunks merge by key minimum in `order`
    (a permutation of the chunk indices), and finish_keys applies the
    miss rule. Equals tri_t_pass_plain bit for bit whatever the chunk
    and order."""
    R = rays8.shape[0]
    live = rays8[:, 6] < rays8[:, 7]
    rays = rays8[live]
    n_stages = tris9.shape[1] // TB
    parts = []
    for s0 in range(0, n_stages, chunk):
        part = torch.full((rays.shape[0],), KEY_EMPTY, dtype=torch.int64, device=rays8.device)
        for s in range(s0, min(s0 + chunk, n_stages)):
            t_blk, prim = _stage_min(rays, tris9, s)
            part = torch.minimum(part, torch.where(t_blk < BIG, pack_keys(t_blk, prim), KEY_EMPTY))
        parts.append(part)
    if sorted(order) != list(range(len(parts))):
        raise ValueError(f"order must be a permutation of range({len(parts)})")
    live_keys = torch.full((rays.shape[0],), KEY_EMPTY, dtype=torch.int64, device=rays8.device)
    for c in order:
        live_keys = torch.minimum(live_keys, parts[c])
    keys = torch.full((R,), KEY_EMPTY, dtype=torch.int64, device=rays8.device)
    keys[live] = live_keys
    return finish_keys(keys, n_tris)


def tri_t_pass_cuda(rays8, tris9, n_tris: int):
    """Launch K1 on the current stream: (t [R], prim [R] int32)."""
    global launches
    R = rays8.shape[0]
    check_cuda(rays8, "rays8", torch.float32, (R, 8))
    check_cuda(tris9, "tris9", torch.float32)
    if tris9.shape[0] != 9 or tris9.shape[1] % TB or tris9.shape[1] == 0:
        raise ValueError(f"tris9: expected [9, k*{TB}], k >= 1, got {tuple(tris9.shape)}")
    if rays8.device != tris9.device:
        raise ValueError("rays8 and tris9 lie on different devices")
    if rays8.data_ptr() % 16 or tris9.data_ptr() % 16:
        raise ValueError("rays8 and tris9 must be 16-byte aligned")
    t = torch.empty((R,), dtype=torch.float32, device=rays8.device)
    p = torch.empty((R,), dtype=torch.int32, device=rays8.device)
    lib = load_kernels()
    # freed on return: the caching allocator reuses it only after the
    # work queued on this stream, K1 included
    scratch = torch.empty((lib.pbrt_tri_t_pass_scratch_bytes(R),), dtype=torch.uint8,
                          device=rays8.device)
    stream = torch.cuda.current_stream(rays8.device).cuda_stream
    err = lib.pbrt_tri_t_pass(rays8.data_ptr(), R, tris9.data_ptr(), tris9.shape[1],
                              n_tris, t.data_ptr(), p.data_ptr(), scratch.data_ptr(), stream)
    raise_on_launch_error(err, "K1 kernels")
    launches += 1
    return t, p


def make_rays8(ray_o, ray_d, tmin, tmax):
    """[R, 8] ray rows with an infinite tmax replaced by BIG."""
    big = torch.full((), BIG, device=ray_o.device)
    return torch.cat([ray_o, ray_d, tmin[:, None],
                      torch.where(torch.isfinite(tmax), tmax, big)[:, None]], -1).contiguous()


def tri_t_pass(soa: TriSoA, ray_o, ray_d, tmin, tmax):
    """[R] rays vs all triangles -> (t, prim int64), prim = -1 on miss
    (reference tri_t_pass_pallas). The kernel for CUDA tensors, its
    plain twin for CPU tensors."""
    fn = tri_t_pass_plain if ray_o.device.type == "cpu" else tri_t_pass_cuda
    t, p = fn(make_rays8(ray_o, ray_d, tmin, tmax), soa.tris9, soa.n)
    return t, p.long()
