"""Perlin gradient noise + FBm/turbulence over batched torch tensors.

Port of pbrt_tpu/textures/noise.py: classic Perlin noise over a hashed
integer lattice. The permutation table is the JAX package's, made the
same way (a seeded NumPy shuffle, duplicated), so the lattice hash is
identical bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_NOISE_PERM_SIZE = 256
_perm = np.random.RandomState(1071).permutation(_NOISE_PERM_SIZE)
NOISE_PERM = np.concatenate([_perm, _perm]).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _perm_on(device) -> torch.Tensor:
    return torch.as_tensor(NOISE_PERM, device=device)


def _grad(h, dx, dy, dz):
    h = h & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1) > 0, -u, u)
    v = torch.where((h & 2) > 0, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise(p):
    """Perlin noise at points p [..., 3] -> [...] in roughly [-1, 1]."""
    perm = _perm_on(p.device)
    fl = torch.floor(p)
    pi = fl.to(torch.int32).to(torch.int64)
    d = p - fl
    ix, iy, iz = pi[..., 0] & 255, pi[..., 1] & 255, pi[..., 2] & 255
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

    def hsh(x, y, z):
        return perm[perm[perm[x] + y] + z]

    w000 = _grad(hsh(ix, iy, iz), dx, dy, dz)
    w100 = _grad(hsh(ix + 1, iy, iz), dx - 1, dy, dz)
    w010 = _grad(hsh(ix, iy + 1, iz), dx, dy - 1, dz)
    w110 = _grad(hsh(ix + 1, iy + 1, iz), dx - 1, dy - 1, dz)
    w001 = _grad(hsh(ix, iy, iz + 1), dx, dy, dz - 1)
    w101 = _grad(hsh(ix + 1, iy, iz + 1), dx - 1, dy, dz - 1)
    w011 = _grad(hsh(ix, iy + 1, iz + 1), dx, dy - 1, dz - 1)
    w111 = _grad(hsh(ix + 1, iy + 1, iz + 1), dx - 1, dy - 1, dz - 1)

    wx, wy, wz = _noise_weight(dx), _noise_weight(dy), _noise_weight(dz)
    x00 = (1 - wx) * w000 + wx * w100
    x10 = (1 - wx) * w010 + wx * w110
    x01 = (1 - wx) * w001 + wx * w101
    x11 = (1 - wx) * w011 + wx * w111
    y0 = (1 - wy) * x00 + wy * x10
    y1 = (1 - wy) * x01 + wy * x11
    return (1 - wz) * y0 + wz * y1


def _octave_sum(p, dpdx_len, dpdy_len, omega: float, max_octaves: int, fold):
    """Sum of fold(noise) over the antialiased octave count (reference
    core/texture.cpp FBm / Turbulence): whole octaves, then a smoothed
    partial one."""
    s2 = torch.maximum(dpdx_len, dpdy_len) ** 2
    foctaves = torch.clamp(-1.0 - 0.5 * torch.log2(torch.clamp(s2, min=1e-30)),
                           0.0, max_octaves)
    octaves = torch.floor(foctaves)
    t = foctaves - octaves
    smooth = t * t * (3.0 - 2.0 * t)
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    zero = torch.zeros((), device=p.device)
    lam, o = 1.0, 1.0
    for i in range(max_octaves):
        n = fold(noise(lam * p))
        total = total + torch.where(i < octaves, o * n, zero)
        total = total + torch.where(i == octaves, o * smooth * n, zero)
        lam *= 1.99
        o *= omega
    return total


def fbm(p, dpdx_len, dpdy_len, omega: float, max_octaves: int):
    """Fractional Brownian motion with antialiased octave clamping."""
    return _octave_sum(p, dpdx_len, dpdy_len, omega, max_octaves, lambda n: n)


def turbulence(p, dpdx_len, dpdy_len, omega: float, max_octaves: int):
    return _octave_sum(p, dpdx_len, dpdy_len, omega, max_octaves, torch.abs)
