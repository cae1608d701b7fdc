"""Sampled spectra as `[..., N_BINS]` arrays (default 30 bins, 400-700nm).

Port of pbrt_tpu/core/spectrum.py. A spectrum is a float32 tensor whose
last axis has N_BINS entries, so whole wavefronts of spectra are 2D
tensors. The host colour science (CIE tables, Smits RGB->spectrum
mixing, SPD binning, blackbody) is NumPy and carried over unchanged;
the device functions (to_xyz, y, the dispersion helpers) take torch
tensors and keep the reference's formulas op for op.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

N_BINS = 30
LAMBDA_START = 400.0
LAMBDA_END = 700.0

# Bin edges and representative wavelengths. The reference indexes bins with
# lambda_i = start + i*(end-start)/(n-1) in splitSpectrum (spectrum.h:254)
# and start + i*(end-start)/n in filter() (spectrum.h:307); we use bin
# midpoints for radiometry and mirror each quirk where behavior matters.
BIN_WIDTH = (LAMBDA_END - LAMBDA_START) / N_BINS
LAMBDAS_EDGE = np.linspace(LAMBDA_START, LAMBDA_END, N_BINS + 1)
LAMBDAS = 0.5 * (LAMBDAS_EDGE[:-1] + LAMBDAS_EDGE[1:])  # midpoints [30]
LAMBDAS_SPLIT = LAMBDA_START + np.arange(N_BINS) * (LAMBDA_END - LAMBDA_START) / (N_BINS - 1)


from pbrt_tpu_torch.core import spectrum_data as _sd

# CIE matching curves averaged per bin exactly like SampledSpectrum::Init
# (reference core/spectrum.h:368-380): [3, 30]
CIE_XYZ_BINS = np.stack([_sd.CIE_X_BINS, _sd.CIE_Y_BINS, _sd.CIE_Z_BINS])
CIE_Y_INT = _sd.CIE_Y_INTEGRAL

# XYZ <-> linear RGB, the reference's literal matrices
# (reference core/spectrum.h:51-64 XYZToRGB / RGBToXYZ)
XYZ_TO_RGB = np.array(
    [
        [3.240479, -1.537150, -0.498535],
        [-0.969256, 1.875991, 0.041556],
        [0.055648, -0.204043, 1.057311],
    ]
)
RGB_TO_XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ]
)

# spectrum -> XYZ: xyz = (sum_i cie_i c_i) * (end-start)/(Y_integral * n)
# (reference core/spectrum.h:420-432 ToXYZ)
_S2XYZ = CIE_XYZ_BINS * ((LAMBDA_END - LAMBDA_START) / (CIE_Y_INT * N_BINS))
S2RGB = XYZ_TO_RGB @ _S2XYZ  # [3, 30]

# Smits RGB->spectrum basis spectra, binned: order matches the mixing
# algorithm below [white, cyan, magenta, yellow, red, green, blue]
_REFL_BASIS = np.stack([
    _sd.RGBRefl2SpectWhite_BINS, _sd.RGBRefl2SpectCyan_BINS,
    _sd.RGBRefl2SpectMagenta_BINS, _sd.RGBRefl2SpectYellow_BINS,
    _sd.RGBRefl2SpectRed_BINS, _sd.RGBRefl2SpectGreen_BINS,
    _sd.RGBRefl2SpectBlue_BINS,
])  # [7, 30]
_ILLUM_BASIS = np.stack([
    _sd.RGBIllum2SpectWhite_BINS, _sd.RGBIllum2SpectCyan_BINS,
    _sd.RGBIllum2SpectMagenta_BINS, _sd.RGBIllum2SpectYellow_BINS,
    _sd.RGBIllum2SpectRed_BINS, _sd.RGBIllum2SpectGreen_BINS,
    _sd.RGBIllum2SpectBlue_BINS,
])
# trailing scale factors (reference core/spectrum.cpp:195,238)
_REFL_SCALE = 0.94
_ILLUM_SCALE = 0.86445


@functools.lru_cache(maxsize=None)
def _const(name: str, device) -> torch.Tensor:
    """float32 device copy of a module constant (cached per device)."""
    table = {"S2XYZ_T": _S2XYZ.T, "Y": _S2XYZ[1], "LAMBDAS_SPLIT": LAMBDAS_SPLIT,
             "BASIS_reflectance": _REFL_BASIS * _REFL_SCALE,
             "BASIS_illuminant": _ILLUM_BASIS * _ILLUM_SCALE}
    return torch.as_tensor(np.ascontiguousarray(table[name], np.float32), device=device)


# ---------------------------------------------------------------------------
# Conversions

def to_xyz(s):
    if isinstance(s, torch.Tensor):
        return s @ _const("S2XYZ_T", s.device)
    return s @ _S2XYZ.T


def y(s):
    """Luminance (CIE Y) of spectrum batch."""
    if isinstance(s, torch.Tensor):
        return s @ _const("Y", s.device)
    return s @ _S2XYZ[1]


def _smits_coeffs(rgb, xp):
    """Basis-mixing coefficients [..., 7] of the reference's FromRGB
    (core/spectrum.cpp:154-243): white gets the min channel, one
    secondary (cyan/magenta/yellow) the mid-min span, one primary the
    max-mid span. Branch precedence (ties) matches the C++ if-chain.
    xp is numpy or torch."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    r_min = (r <= g) & (r <= b)
    g_min = ~r_min & (g <= r) & (g <= b)
    b_min = ~r_min & ~g_min
    zero = xp.zeros_like(r)
    white = xp.where(r_min, r, xp.where(g_min, g, b))
    cyan = xp.where(r_min, xp.where(g <= b, g - r, b - r), zero)
    magenta = xp.where(g_min, xp.where(r <= b, r - g, b - g), zero)
    yellow = xp.where(b_min, xp.where(r <= g, r - b, g - b), zero)
    blue = (xp.where(r_min & (g <= b), b - g, zero)
            + xp.where(g_min & (r <= b), b - r, zero))
    green = (xp.where(r_min & (g > b), g - b, zero)
             + xp.where(b_min & (r <= g), g - r, zero))
    red = (xp.where(g_min & (r > b), r - b, zero)
           + xp.where(b_min & (r > g), r - g, zero))
    return xp.stack([white, cyan, magenta, yellow, red, green, blue], -1)


def from_rgb(rgb, kind: str = "reflectance"):
    """RGB [..., 3] -> spectrum [..., 30] via the reference's Smits-style
    basis mixing (SampledSpectrum::FromRGB). NOT an exact round-trip:
    the basis desaturates slightly, identically to pbrt. A float32
    tensor stays on its device (textures evaluated per hit); anything
    else is converted on the host in float64."""
    basis = _REFL_BASIS if kind == "reflectance" else _ILLUM_BASIS
    scale = _REFL_SCALE if kind == "reflectance" else _ILLUM_SCALE
    if isinstance(rgb, torch.Tensor):
        c = _smits_coeffs(rgb, torch)
        return torch.clamp(c @ _const(f"BASIS_{kind}", rgb.device), min=0.0)
    rgb = np.asarray(rgb, np.float64)
    c = _smits_coeffs(rgb, np)
    return np.clip(c @ (basis * scale), 0.0, None).astype(np.float32)


def to_rgb(s: np.ndarray) -> np.ndarray:
    """Spectrum [..., 30] -> linear RGB [..., 3] (host, NumPy)."""
    return s @ S2RGB.T


def from_sampled(lambdas, values) -> np.ndarray:
    """Piecewise-linear SPD samples -> binned spectrum (host, NumPy).

    Exact piecewise-linear average over each bin with constant
    extension outside the sample range (reference core/spectrum.cpp
    AverageSpectrumSamples, :58-91).
    """
    lam = np.asarray(lambdas, np.float64)
    val = np.asarray(values, np.float64)
    order = np.argsort(lam, kind="stable")
    lam, val = lam[order], val[order]
    n = len(lam)

    def avg(l0, l1):
        if l1 <= lam[0]:
            return val[0]
        if l0 >= lam[-1]:
            return val[-1]
        if n == 1:
            return val[0]
        s = 0.0
        if l0 < lam[0]:
            s += val[0] * (lam[0] - l0)
        if l1 > lam[-1]:
            s += val[-1] * (l1 - lam[-1])
        i = 0
        while l0 > lam[i + 1]:
            i += 1

        def interp(w, i):
            t = (w - lam[i]) / (lam[i + 1] - lam[i])
            return val[i] * (1 - t) + val[i + 1] * t

        while i + 1 < n and l1 >= lam[i]:
            a, b = max(l0, lam[i]), min(l1, lam[i + 1])
            if b > a:
                s += 0.5 * (interp(a, i) + interp(b, i)) * (b - a)
            i += 1
        return s / (l1 - l0)

    out = np.array([avg(LAMBDAS_EDGE[i], LAMBDAS_EDGE[i + 1])
                    for i in range(N_BINS)])
    return out.astype(np.float32)


def constant(v, shape=(), *, device):
    return torch.full(tuple(shape) + (N_BINS,), v, dtype=torch.float32, device=device)


def blackbody(temp_k: float) -> np.ndarray:
    """Planck blackbody SPD binned (host), normalized to max 1."""
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    lam_m = LAMBDAS * 1e-9
    le = (2 * h * c * c) / (lam_m ** 5 * (np.exp(h * c / (lam_m * kb * temp_k)) - 1.0))
    return (le / le.max()).astype(np.float32)


# ---------------------------------------------------------------------------
# Student dispersion extensions, wavefront form

def intensity_at(s, lam):
    """Linear interpolation of the bin values at wavelength lam on the
    reference's (n - 1) grid (spectrum.h:281-291)."""
    delta = (LAMBDA_END - LAMBDA_START) / (N_BINS - 1)
    iw = (lam - LAMBDA_START) / delta
    i0 = torch.clamp(torch.floor(iw).to(torch.int64), 0, N_BINS - 2)
    t = iw - i0
    v0 = torch.gather(s, -1, i0[..., None])[..., 0]
    v1 = torch.gather(s, -1, (i0 + 1)[..., None])[..., 0]
    return (1.0 - t) * v0 + t * v1


def band_filter(s, lam):
    """2-bin linear band-pass at lam (reference spectrum.h filter()).

    Out-of-range lam -> zero spectrum. Mirrors the reference's weights:
    bin i gets c[i]*t, bin i+1 gets c[i+1]*(1-t) with
    i = floor((lam-400)/(300/n)).
    """
    delta = (LAMBDA_END - LAMBDA_START) / N_BINS
    iw = (lam - LAMBDA_START) / delta
    idx = torch.floor(iw).to(torch.int32)
    t = iw - idx
    valid = (lam >= LAMBDA_START) & (lam < LAMBDA_END)
    idx = torch.clamp(idx, 0, N_BINS - 1)
    bins = torch.arange(N_BINS, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    w = torch.where(bins == idx[..., None], t[..., None], zero)
    w = w + torch.where(bins == (idx + 1)[..., None], (1.0 - t)[..., None], zero)
    return torch.where(valid[..., None], s * w, zero)


def one_hot(idx):
    """Monochromatic spectrum: one-hot at bin idx."""
    return (torch.arange(N_BINS, device=idx.device) == idx[..., None]).to(torch.float32)


def bin_wavelength(idx):
    """Wavelength carried by bin idx, matching splitSpectrum's grid."""
    return _const("LAMBDAS_SPLIT", idx.device)[idx]


def sample_bin(s, u):
    """Importance-sample ONE wavelength bin per lane: returns (idx, weight).

    weight = total/pdf adjustment such that one_hot(idx)*s[idx]/pdf is an
    unbiased estimator of the dense spectrum (replaces the reference's
    splitSpectrum 1->k enumeration, photonshooter.cpp:141-145).
    """
    tot = torch.sum(s, -1)
    p = s / torch.clamp(tot[..., None], min=1e-20)
    cdf = torch.cumsum(p, -1)
    idx = torch.sum((u[..., None] > cdf).to(torch.int32), -1)
    idx = torch.clamp(idx, 0, N_BINS - 1).long()
    pdf = torch.gather(p, -1, idx[..., None])[..., 0]
    return idx, torch.where(tot > 0, 1.0 / torch.clamp(pdf, min=1e-20),
                            torch.zeros((), device=s.device))


def is_black(s):
    return torch.all(s <= 0.0, -1)
