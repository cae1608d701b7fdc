"""Monte Carlo sampling substrate, vectorized over wavefront batches.

Port of the parts of pbrt_tpu/core/sampling.py the ported paths use:
Distribution1D (light pick), the sphere, cone, concentric disk and
cosine hemisphere warps, triangle sampling, the power heuristic, the
Henyey-Greenstein phase function, and the base-2 low-discrepancy
points. uint32 arithmetic is carried in int64 tensors masked to 32 bits
after every step, so the bit streams equal the JAX package's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Distribution1D (reference montecarlo.h:54)

class Distribution1D(NamedTuple):
    """Piecewise-constant 1D distribution over [0,1]: func [n],
    cdf [n+1], func_int []."""

    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @staticmethod
    def make(func):
        func = func.to(torch.float32)
        n = func.shape[-1]
        integ = torch.cumsum(func, -1) / n
        func_int = integ[..., -1]
        zero = torch.zeros(func.shape[:-1] + (1,), dtype=func.dtype, device=func.device)
        # uniform fallback if the function integrates to zero
        safe = func_int[..., None] > 0
        cdf = torch.where(
            safe,
            torch.cat([zero, integ], -1) / torch.clamp(func_int[..., None], min=1e-30),
            torch.linspace(0.0, 1.0, n + 1, device=func.device),
        )
        return Distribution1D(func, cdf, func_int)

    @property
    def count(self):
        return self.func.shape[-1]

    def sample_discrete(self, u):
        """u: [...] -> (offset, pmf)."""
        n = self.count
        off = torch.clamp(torch.sum((u[..., None] >= self.cdf[1:]).to(torch.int32), -1), 0, n - 1)
        f = self.func[off.long()]
        pmf = f / torch.clamp(self.func_int * n, min=1e-30)
        return off, pmf

    def pdf_discrete(self, off):
        f = self.func[off.long()]
        return f / torch.clamp(self.func_int * self.count, min=1e-30)


# ---------------------------------------------------------------------------
# Shape sampling (reference montecarlo.h:117-141 and .cpp)

def uniform_sample_sphere(u1, u2):
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def uniform_sample_cone(u1, u2, cos_theta_max):
    cos_t = (1.0 - u1) + u1 * cos_theta_max
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * math.pi * torch.clamp(1.0 - cos_theta_max, min=1e-8))


def concentric_sample_disk(u1, u2):
    """Shirley-Chiu concentric map, branch-free."""
    sx = 2.0 * u1 - 1.0
    sy = 2.0 * u2 - 1.0
    r = torch.where(torch.abs(sx) > torch.abs(sy), torch.abs(sx), torch.abs(sy))
    use_x = torch.abs(sx) > torch.abs(sy)
    tiny = torch.full((), 1e-12, device=u1.device)
    safe_sx = torch.where(torch.abs(sx) < 1e-12, tiny, sx)
    safe_sy = torch.where(torch.abs(sy) < 1e-12, tiny, sy)
    theta = torch.where(
        use_x,
        (math.pi / 4.0) * (sy / safe_sx),
        (math.pi / 2.0) - (math.pi / 4.0) * (sx / safe_sy),
    )
    theta = torch.where(use_x & (sx < 0), theta + math.pi, theta)
    theta = torch.where(~use_x & (sy < 0), theta + math.pi, theta)
    zero = (sx == 0.0) & (sy == 0.0)
    r = torch.where(zero, torch.zeros((), device=u1.device), r)
    return r * torch.cos(theta), r * torch.sin(theta)


def cosine_sample_hemisphere(u1, u2):
    x, y_ = concentric_sample_disk(u1, u2)
    z = torch.sqrt(torch.clamp(1.0 - x * x - y_ * y_, min=0.0))
    return torch.stack([x, y_, z], -1)


def uniform_sample_triangle(u1, u2):
    su1 = torch.sqrt(u1)
    return 1.0 - su1, u2 * su1  # barycentric (b0, b1)


# ---------------------------------------------------------------------------
# MIS heuristics (reference montecarlo.h:253-265)

def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-30)


def phase_mie_hazy(cos_t):
    return (0.5 + 4.5 * ((1.0 + cos_t) / 2.0) ** 8) * INV_FOURPI


def phase_hg(cos_t, g):
    """Henyey-Greenstein phase function (reference core/volume.cpp)."""
    g2 = g * g
    denom = 1.0 + g2 + 2.0 * g * cos_t
    return INV_FOURPI * (1.0 - g2) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


# ---------------------------------------------------------------------------
# Low-discrepancy points (reference montecarlo.h:221-319). Inputs are
# int64 tensors holding uint32 values.

def mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 x held in int64 and a constant c.
    The 32x32-bit product can pass 2^63, so c is split in 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def reverse_bits32(n):
    n = ((n << 16) | (n >> 16)) & M32
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def u32_to_unit(bits):
    """Top 24 bits of a uint32 -> float32 in [0, 1) (exact)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def van_der_corput(n, scramble):
    """Base-2 radical inverse with bit-xor scramble (montecarlo.h:246)."""
    return u32_to_unit(reverse_bits32(n) ^ scramble)


def sobol2(n, scramble):
    """Second dimension of the (0,2)-sequence (montecarlo.h Sobol2)."""
    v = torch.full_like(n, 1 << 31)
    result = scramble.expand_as(n).clone()
    for _ in range(32):
        result = torch.where((n & 1) > 0, result ^ v, result)
        n = n >> 1
        v = v ^ (v >> 1)
    return u32_to_unit(result)
