"""Monte Carlo sampling substrate, vectorized over wavefront batches.

Port of pbrt_tpu/core/sampling.py: Distribution1D (light pick) and
Distribution2D (environment-map importance), the hemisphere, sphere,
cone, concentric disk and cosine hemisphere warps, triangle sampling,
the phase functions and Henyey-Greenstein sampling, the balance and
power heuristics, the base-2 low-discrepancy points and (0,2)-sequence,
the Halton radical inverse, and the stratified and Latin-hypercube
patterns (on the port's threefry keys, core/threefry.py, so they equal
the JAX package's jax.random draws). uint32 arithmetic is carried in
int64 tensors masked to 32 bits after every step, so the bit streams
equal the JAX package's.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.core import threefry
from pbrt_tpu_torch.core.geometry import coordinate_system

INV_PI = 1.0 / math.pi
INV_TWOPI = 1.0 / (2.0 * math.pi)
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

    def sample_continuous(self, u):
        """u: [...] -> (x in [0,1), pdf, offset int64). The segment is
        the count of u >= cdf[1:], found by a sorted search."""
        n = self.count
        off = torch.clamp(torch.searchsorted(self.cdf[1:].contiguous(), u.contiguous(),
                                             right=True), 0, n - 1)
        c0 = self.cdf[off]
        c1 = self.cdf[off + 1]
        du = torch.where(c1 > c0, (u - c0) / torch.clamp(c1 - c0, min=1e-30),
                         torch.zeros((), device=u.device))
        x = (off + du) / n
        pdf = self.func[off] / torch.clamp(self.func_int, min=1e-30)
        return x, pdf, off

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


def dist1d_host(func: np.ndarray):
    """Distribution1D tables (func, cdf, func_int) of func [..., n] on
    the host: float32 throughout, the running sums taken left to right
    along the last axis (np.cumsum), as Distribution1D.make does them."""
    func = np.asarray(func, np.float32)
    n = func.shape[-1]
    integ = np.cumsum(func, axis=-1, dtype=np.float32) / np.float32(n)
    func_int = integ[..., -1]
    zero = np.zeros(func.shape[:-1] + (1,), np.float32)
    safe = func_int[..., None] > 0
    cdf = np.where(safe,
                   np.concatenate([zero, integ], -1) / np.maximum(func_int[..., None],
                                                                 np.float32(1e-30)),
                   np.linspace(0.0, 1.0, n + 1, dtype=np.float32))
    return func, cdf.astype(np.float32), func_int.astype(np.float32)


class Distribution2D(NamedTuple):
    """2D piecewise-constant distribution (environment-map importance,
    reference montecarlo.h:142): cond over u per v row (func [nv, nu]),
    marg over v (func [nv])."""

    cond: Distribution1D
    marg: Distribution1D

    @staticmethod
    def make(func, device):
        """Tables built on the host (dist1d_host), then moved to device."""
        cf, cc, ci = dist1d_host(func)
        mf, mc, mi = dist1d_host(ci)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return Distribution2D(Distribution1D(dev(cf), dev(cc), dev(ci)),
                              Distribution1D(dev(mf), dev(mc), dev(mi)))

    def sample_continuous(self, u0, u1):
        """-> ((u, v), pdf). The column within the sampled row is the
        count of u0 >= row_cdf[1:], found by one sorted search over int64
        keys (row, bits of the CDF value): both are >= 0 and each row's
        CDF is nondecreasing, so the keys ascend over the whole table,
        and no row is gathered per sample."""
        v, pdf_v, iv = self.marg.sample_continuous(u1)
        nv, nu = self.cond.func.shape
        cdf = self.cond.cdf
        off = self.column(iv, u0)
        c0 = cdf[iv, off]
        c1 = cdf[iv, off + 1]
        f = self.cond.func[iv, off]
        du = torch.where(c1 > c0, (u0 - c0) / torch.clamp(c1 - c0, min=1e-30),
                         torch.zeros((), device=u0.device))
        u = (off + du) / nu
        pdf_u = f / torch.clamp(self.cond.func_int[iv], min=1e-30)
        return (u, v), pdf_u * pdf_v

    def column(self, iv, u0):
        """The segment of u0 in row iv of the conditional CDFs: the
        count of u0 >= cdf[iv, 1:] (clipped to [0, nu - 1])."""
        nv, nu = self.cond.func.shape
        rows = torch.arange(nv, device=u0.device)[:, None]
        keys = ((rows << 32) | f32_bits(self.cond.cdf[:, 1:])).reshape(-1)
        j = torch.searchsorted(keys, (iv << 32) | f32_bits(u0), right=True)
        return torch.clamp(j - iv * nu, 0, nu - 1)

    def pdf(self, u, v):
        nv, nu = self.cond.func.shape
        iu = torch.clamp((u * nu).to(torch.int64), 0, nu - 1)
        iv = torch.clamp((v * nv).to(torch.int64), 0, nv - 1)
        return self.cond.func[iv, iu] / torch.clamp(self.marg.func_int, min=1e-30)


def f32_bits(x):
    """Bits of float32 x >= 0 as int64 (they order as the values)."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)


# ---------------------------------------------------------------------------
# Shape sampling (reference montecarlo.h:117-141 and .cpp)

def uniform_sample_hemisphere(u1, u2):
    z = u1
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


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


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def uniform_sample_triangle(u1, u2):
    su1 = torch.sqrt(u1)
    return 1.0 - su1, u2 * su1  # barycentric (b0, b1)


# ---------------------------------------------------------------------------
# MIS heuristics (reference montecarlo.h:253-265)

def balance_heuristic(nf, f_pdf, ng, g_pdf):
    return (nf * f_pdf) / torch.clamp(nf * f_pdf + ng * g_pdf, min=1e-30)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=1e-30)


# ---------------------------------------------------------------------------
# Phase functions (reference core/volume.h:47-52) of the cosine between
# unit w and wi

def phase_isotropic():
    return INV_FOURPI


def phase_rayleigh(cos_t):
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_t * cos_t)


def phase_mie_hazy(cos_t):
    return (0.5 + 4.5 * ((1.0 + cos_t) / 2.0) ** 8) * INV_FOURPI


def phase_mie_murky(cos_t):
    x = (1.0 + cos_t) / 2.0
    for _ in range(5):   # x ** 32 by squaring, as XLA's integer power rounds it
        x = x * x
    return (0.5 + 16.5 * x) * INV_FOURPI


def phase_hg(cos_t, g):
    """Henyey-Greenstein phase function (reference core/volume.cpp)."""
    g2 = g * g
    denom = 1.0 + g2 + 2.0 * g * cos_t
    return INV_FOURPI * (1.0 - g2) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=1e-12)), min=1e-12)


def phase_schlick(cos_t, g):
    k = 1.55 * g - 0.55 * g * g * g
    kc = 1.0 + k * cos_t
    return INV_FOURPI * (1.0 - k * k) / torch.clamp(kc * kc, min=1e-12)


def sample_hg(w, u1, u2, g):
    """Sample wi from the HG phase around unit w; its pdf is
    phase_hg(w . wi, g) (reference core/montecarlo.h SampleHG)."""
    g = torch.broadcast_to(torch.as_tensor(g, dtype=torch.float32, device=u1.device), u1.shape)
    iso = torch.abs(g) < 1e-3
    safe_g = torch.where(iso, torch.ones((), device=u1.device), g)
    sqr = (1.0 - g * g) / torch.clamp(1.0 - g + 2.0 * g * u1, min=1e-8)
    cost = torch.where(iso, 1.0 - 2.0 * u1, (1.0 + g * g - sqr * sqr) / (2.0 * safe_g))
    cost = torch.clamp(cost, -1.0, 1.0)
    sint = torch.sqrt(torch.clamp(1.0 - cost * cost, min=0.0))
    phi = 2.0 * math.pi * u2
    v1, v2 = coordinate_system(w)
    return ((sint * torch.cos(phi))[..., None] * v1 + (sint * torch.sin(phi))[..., None] * v2
            + cost[..., None] * w)


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


def sample02(n, scramble_xy):
    """(0,2)-sequence sample n with the 2D scramble [..., 2] -> (x, y)."""
    return van_der_corput(n, scramble_xy[..., 0]), sobol2(n, scramble_xy[..., 1])


# Halton: radical inverse in the first 32 prime bases (montecarlo.h:221)
PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
          73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131)


def radical_inverse(n, base: int):
    """Radical inverse of integer tensor n (int32 values) in `base`: 32
    digits accumulated in float32 in the JAX package's compiled order.
    XLA turns its division of the digit weight by `base` into a product
    with the float32 reciprocal, and contracts each digit's multiply-add
    into one fused multiply-add; the fused step is done here in float64
    (digit times weight is exact there) and rounded once to float32."""
    n = n.to(torch.int64)
    val = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv_bi = torch.tensor(1.0 / base, dtype=torch.float32, device=n.device)
    recip = torch.tensor(1.0 / base, dtype=torch.float32, device=n.device)
    for _ in range(32):
        val = ((n % base).to(torch.float64) * inv_bi.to(torch.float64)
               + val.to(torch.float64)).to(torch.float32)
        n = n // base
        inv_bi = inv_bi * recip
    return val


def halton_nd(n, dim: int):
    """First `dim` Halton dimensions of index batch n -> [..., dim]."""
    return torch.stack([radical_inverse(n, PRIMES[d]) for d in range(dim)], -1)


# ---------------------------------------------------------------------------
# Pixel sample patterns, on threefry keys (core/threefry.py)

def stratified_2d(key, nx: int, ny: int, jitter: bool = True, *, device):
    """[nx*ny, 2] stratified samples, jittered by threefry.uniform."""
    ij = torch.stack(torch.meshgrid(torch.arange(nx, device=device),
                                    torch.arange(ny, device=device), indexing="ij"),
                     -1).reshape(-1, 2)
    u = (threefry.uniform(key, (nx * ny, 2), device) if jitter
         else torch.full((nx * ny, 2), 0.5, device=device))
    return (ij + u) / torch.tensor([nx, ny], dtype=torch.float32, device=device)


def stratified_1d(key, n: int, jitter: bool = True, *, device):
    i = torch.arange(n, dtype=torch.float32, device=device)
    u = threefry.uniform(key, (n,), device) if jitter else torch.full((n,), 0.5, device=device)
    return (i + u) / n


def latin_hypercube(key, n: int, dim: int, *, device):
    """[n, dim] Latin-hypercube samples: jittered strata, each dimension
    under its own threefry.permutation."""
    k1, k2 = threefry.split(key)
    u = threefry.uniform(k1, (n, dim), device)
    samples = (torch.arange(n, device=device)[:, None] + u) / n
    perms = torch.stack([threefry.permutation(threefry.fold_in(k2, d), n, device)
                         for d in range(dim)], 1)
    return torch.gather(samples, 0, perms)
