"""K1: the flat ray-triangle t-pass, a CUDA kernel and its plain twin.

Port of pbrt_tpu/ops/intersect_pallas.py. The Pallas TPU kernel
`_tri_kernel` becomes `tri_t_pass_kernel` in csrc/intersect.cu (one
thread per ray, triangle blocks staged in shared memory); the layouts
stay the reference's: rays `[R, 8]` (o, d, tmin, tmax), triangles
`[9, T]` component-major v0/e1/e2 padded to a multiple of 256.

`tri_t_pass` dispatches on the tensors' device: CUDA tensors launch the
kernel (or raise), CPU tensors run `tri_t_pass_plain`, the same
arithmetic in plain torch.
"""
from __future__ import annotations

import torch

from pbrt_tpu_torch.ops.build import check_cuda, load_kernels, raise_on_launch_error

BIG = 1e30
TB = 256   # triangles per block (kernel shared-memory stage)

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


def tri_t_pass_plain(rays8, tris9, n_tris: int):
    """Plain torch twin of the kernel: (t [R], prim [R] int32)."""
    R = rays8.shape[0]
    dev = rays8.device
    big = torch.full((), BIG, device=dev)
    o = [rays8[:, i:i + 1] for i in range(6)]
    tmin, tmax = rays8[:, 6:7], rays8[:, 7:8]
    t_best = torch.full((R,), BIG, device=dev)
    p_best = torch.full((R,), -1, dtype=torch.int32, device=dev)
    from pbrt_tpu_torch.accel.intersect import mt_t

    for s in range(0, tris9.shape[1], TB):
        tri = [tris9[c:c + 1, s:s + TB] for c in range(9)]
        t, valid = mt_t(*tri, *o, tmin, tmax)
        t = torch.where(valid, t, big)
        t_blk, idx = torch.min(t, -1)
        better = t_blk < t_best
        t_best = torch.where(better, t_blk, t_best)
        p_best = torch.where(better, (s + idx).to(torch.int32), p_best)
    miss = (p_best < 0) | (p_best >= n_tris) | (t_best >= BIG)
    return torch.where(miss, big, t_best), torch.where(miss, -1, p_best)


def tri_t_pass_cuda(rays8, tris9, n_tris: int):
    """Launch K1 on the current stream: (t [R], prim [R] int32)."""
    global launches
    R = rays8.shape[0]
    check_cuda(rays8, "rays8", torch.float32, (R, 8))
    check_cuda(tris9, "tris9", torch.float32)
    if tris9.shape[0] != 9 or tris9.shape[1] % TB:
        raise ValueError(f"tris9: expected [9, k*{TB}], got {tuple(tris9.shape)}")
    if rays8.device != tris9.device:
        raise ValueError("rays8 and tris9 lie on different devices")
    t = torch.empty((R,), dtype=torch.float32, device=rays8.device)
    p = torch.empty((R,), dtype=torch.int32, device=rays8.device)
    lib = load_kernels()
    stream = torch.cuda.current_stream(rays8.device).cuda_stream
    err = lib.pbrt_tri_t_pass(rays8.data_ptr(), R, tris9.data_ptr(), tris9.shape[1],
                              n_tris, t.data_ptr(), p.data_ptr(), stream)
    raise_on_launch_error(err, "tri_t_pass_kernel")
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
