"""Real spherical harmonics: evaluation, projection, convolution, rotation.

Port of pbrt_tpu/core/sh.py (reference core/sh.{h,cpp}): SHTerms /
SHIndex, SHEvaluate (the real SH basis by the standard recurrences, on
the caller's device), the cosine-lobe convolution coefficients
(lambda_l), projection of sampled functions, a product quadrature over
the sphere, and the block-diagonal rotation matrices of shrots.cpp by
the Ivanic-Ruedenberg recurrence (host NumPy: the blocks are tiny and
scene-constant).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sh_terms(lmax: int) -> int:
    return (lmax + 1) * (lmax + 1)


def sh_index(l: int, m: int) -> int:
    return l * l + l + m


def _legendre_p(lmax: int, z):
    """Associated Legendre P_l^m(z) for all l <= lmax, m >= 0 ->
    dict[(l, m)] -> tensor like z (reference core/sh.cpp legendrep)."""
    P = {(0, 0): torch.ones_like(z)}
    if lmax == 0:
        return P
    z2 = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    for m in range(0, lmax + 1):
        if m > 0:
            P[(m, m)] = (1.0 - 2.0 * m) * z2 * P[(m - 1, m - 1)]
        if m + 1 <= lmax:
            P[(m + 1, m)] = z * (2.0 * m + 1.0) * P[(m, m)]
        for l in range(m + 2, lmax + 1):
            P[(l, m)] = ((2.0 * l - 1.0) * z * P[(l - 1, m)]
                         - (l + m - 1.0) * P[(l - 2, m)]) / (l - m)
    return P


def _K(l: int, m: int) -> float:
    return math.sqrt((2.0 * l + 1.0) * math.factorial(l - abs(m))
                     / (4.0 * math.pi * math.factorial(l + abs(m))))


def sh_evaluate(w, lmax: int):
    """Real SH basis values at unit directions w [..., 3] ->
    [..., sh_terms(lmax)] (reference core/sh.h:55 SHEvaluate)."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    P = _legendre_p(lmax, z)
    phi = torch.atan2(y, x)
    sqrt2 = math.sqrt(2.0)
    out = []
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            if m == 0:
                out.append(_K(l, 0) * P[(l, 0)])
            elif m > 0:
                out.append(sqrt2 * _K(l, m) * torch.cos(m * phi) * P[(l, m)])
            else:
                out.append(sqrt2 * _K(l, m) * torch.sin(-m * phi) * P[(l, -m)])
    return torch.stack(out, -1)


def lambda_l(lmax: int) -> np.ndarray:
    """Cosine-lobe convolution coefficients A_l (Ramamoorthi-Hanrahan),
    expanded per (l, m): E(n) = sum A_l c_lm Y_lm(n) (reference
    core/sh.cpp SHConvolveCosTheta). A_0 = pi, A_1 = 2pi/3, odd l > 1
    vanish."""
    coeffs = np.zeros(sh_terms(lmax))
    for l in range(lmax + 1):
        if l == 0:
            a = math.pi
        elif l == 1:
            a = 2.0 * math.pi / 3.0
        elif l % 2 == 1:
            a = 0.0
        else:
            a = (2.0 * math.pi * (-1.0) ** (l // 2 - 1) / ((l + 2) * (l - 1))
                 * math.factorial(l) / (2 ** l * math.factorial(l // 2) ** 2))
        for m in range(-l, l + 1):
            coeffs[sh_index(l, m)] = a
    return coeffs


def project_function(fn_vals, dirs, weights, lmax: int):
    """Quadrature projection sum_i w_i f_i Y(w_i): fn_vals [N, C],
    dirs [N, 3], weights [N] -> [terms, C]."""
    Y = sh_evaluate(dirs, lmax)
    return torch.einsum("nt,nc->tc", Y * weights[:, None], fn_vals)


def sphere_quadrature(n_theta: int = 32, n_phi: int = 64, device=None):
    """Product quadrature over the sphere -> (dirs [N, 3], weights [N])
    float32 tensors."""
    th = (np.arange(n_theta) + 0.5) / n_theta * np.pi
    ph = (np.arange(n_phi) + 0.5) / n_phi * 2.0 * np.pi
    T, PH = np.meshgrid(th, ph, indexing="ij")
    st = np.sin(T)
    dirs = np.stack([st * np.cos(PH), st * np.sin(PH), np.cos(T)], -1).reshape(-1, 3)
    w = (st * (np.pi / n_theta) * (2.0 * np.pi / n_phi)).reshape(-1)
    return (torch.as_tensor(dirs.astype(np.float32), device=device),
            torch.as_tensor(w.astype(np.float32), device=device))


# ---------------------------------------------------------------------------
# SH rotation (reference core/shrots.cpp SHRotate, sh.h:55-58), by the
# Ivanic-Ruedenberg recurrence (J. Phys. Chem. 1996, with the 1998
# errata signs) on the host.

def _ir_block(l: int, R1, Rlm1):
    """Band-l rotation block from the band-1 matrix R1 (indexed
    [m+1][n+1]) and the band-(l-1) block Rlm1 (indexed [m+l-1][n+l-1])."""

    def r1(i, j):
        return R1[i + 1][j + 1]

    def rp(a, b):
        return Rlm1[a + l - 1][b + l - 1]

    def P(i, a, b):
        if b == l:
            return r1(i, 1) * rp(a, l - 1) - r1(i, -1) * rp(a, -(l - 1))
        if b == -l:
            return r1(i, 1) * rp(a, -(l - 1)) + r1(i, -1) * rp(a, l - 1)
        return r1(i, 0) * rp(a, b)

    M = np.zeros((2 * l + 1, 2 * l + 1))
    for m in range(-l, l + 1):
        for n in range(-l, l + 1):
            denom = (l + n) * (l - n) if abs(n) < l else (2 * l) * (2 * l - 1)
            u = math.sqrt((l + m) * (l - m) / denom)
            dm0 = 1.0 if m == 0 else 0.0
            v = (0.5 * math.sqrt((1 + dm0) * (l + abs(m) - 1) * (l + abs(m)) / denom)
                 * (1 - 2 * dm0))
            w = -0.5 * math.sqrt((l - abs(m) - 1) * (l - abs(m)) / denom) * (1 - dm0)
            val = 0.0
            if u != 0.0:
                val += u * P(0, m, n)
            if v != 0.0:
                if m == 0:
                    V = P(1, 1, n) + P(-1, -1, n)
                elif m > 0:
                    d = 1.0 if m == 1 else 0.0
                    V = P(1, m - 1, n) * math.sqrt(1 + d) - P(-1, -(m - 1), n) * (1 - d)
                else:
                    d = 1.0 if m == -1 else 0.0
                    V = P(1, m + 1, n) * (1 - d) + P(-1, -(m + 1), n) * math.sqrt(1 + d)
                val += v * V
            if w != 0.0:
                if m > 0:
                    W = P(1, m + 1, n) + P(-1, -(m + 1), n)
                else:
                    W = P(1, m - 1, n) - P(-1, -(m - 1), n)
                val += w * W
            M[m + l][n + l] = val
    return M


def sh_rotation_blocks(R, lmax: int):
    """Per-band real-SH rotation matrices for the world rotation R [3, 3]:
    a list of [2l+1, 2l+1] NumPy arrays with Y_l(R w) = M_l @ Y_l(w) in
    this module's basis (which carries the Condon-Shortley phase). The
    recurrence is stated for the CS-free basis, so each band is
    conjugated by diag((-1)^m) on the way out."""
    R = np.asarray(R, np.float64)
    blocks = [np.ones((1, 1))]
    if lmax == 0:
        return blocks
    perm = [1, 2, 0]   # band 1 (m = -1, 0, 1) spans (y, z, x)
    M1 = np.array([[R[perm[i]][perm[j]] for j in range(3)] for i in range(3)])
    raw = [M1]
    prev = M1
    for l in range(2, lmax + 1):
        prev = _ir_block(l, M1, prev)
        raw.append(prev)
    for l, bl in enumerate(raw, start=1):
        d = np.array([(-1.0) ** m for m in range(-l, l + 1)])
        blocks.append(bl * d[:, None] * d[None, :])
    return blocks


def sh_rotation_matrix(R, lmax: int) -> np.ndarray:
    """Block-diagonal [T, T] rotation of a full coefficient vector."""
    T = sh_terms(lmax)
    M = np.zeros((T, T))
    o = 0
    for bl in sh_rotation_blocks(R, lmax):
        n = bl.shape[0]
        M[o:o + n, o:o + n] = bl
        o += n
    return M


def rotate_sh(c, R, lmax: int):
    """Rotate SH coefficients: f'(w) = f(R^T w) <=> c' = M(R) c.
    c: [..., T] or [T, C] tensor; returns the matching shape."""
    M = torch.as_tensor(sh_rotation_matrix(R, lmax).astype(np.float32), device=c.device)
    if c.ndim == 2 and c.shape[0] == M.shape[0]:
        return M @ c
    return torch.einsum("ts,...s->...t", M, c)
