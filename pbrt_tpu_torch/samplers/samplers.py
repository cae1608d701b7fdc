"""Pixel samplers: batched camera-sample generation.

Port of pbrt_tpu/samplers/samplers.py (reference samplers/*.cpp). All
samples for a pixel batch are generated at once as flat tensors, from
counter-based hashes of (pixel, sample, dimension, seed): the streams
are bit-identical to the JAX package's (uint32 arithmetic in int64,
masked after every step).

Kinds: stratified (jittered strata), lowdiscrepancy (per-pixel
scrambled (0,2)-sequence, reference samplers/lowdiscrepancy.cpp:87),
halton (global Halton points with a per-pixel Cranley-Patterson
rotation), random, bestcandidate (the precomputed dart-throwing table
bestcandidate.npy, this package's copy of the JAX package's, tiled
over the image; reference samplers/bestcandidate.cpp:99), adaptive
(a minsamples pass with a contrast or shape-id veto: vetoed pixels are
re-rendered at maxsamples and their first samples discarded,
reference samplers/adaptive.cpp:182-185; the two passes are in
renderers/driver.py render_tile).
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.core.error import warning
from pbrt_tpu_torch.core.sampling import (
    M32,
    halton_nd,
    mul32,
    sobol2,
    u32_to_unit,
    van_der_corput,
)
from pbrt_tpu_torch.scene.paramset import ParamSet

S_STRATIFIED, S_LOWDISCREPANCY, S_HALTON, S_RANDOM, S_BESTCANDIDATE, S_ADAPTIVE = range(6)


def _round_pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


@dataclass
class SamplerSpec:
    kind: int
    spp: int
    jitter: bool = True
    nx: int = 2            # stratified strata
    ny: int = 2
    adaptive_min: int = 4
    adaptive_max: int = 32
    adaptive_method: str = "contrast"  # or "shapeid"


def make_sampler(name: str, params: ParamSet, options=None) -> SamplerSpec:
    options = options or {}
    quick = bool(options.get("quick"))
    if name == "stratified":
        nx = params.find_one_int("xsamples", 2)
        ny = params.find_one_int("ysamples", 2)
        jitter = params.find_one_bool("jitter", True)
        if quick:
            nx, ny = 1, 1
        sp = SamplerSpec(S_STRATIFIED, nx * ny, jitter, nx, ny)
    elif name == "lowdiscrepancy" or name == "bestcandidate":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        kind = S_LOWDISCREPANCY if name == "lowdiscrepancy" else S_BESTCANDIDATE
        sp = SamplerSpec(kind, _round_pow2(ps))
    elif name == "halton":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        sp = SamplerSpec(S_HALTON, ps)
    elif name == "random":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        sp = SamplerSpec(S_RANDOM, ps)
    elif name == "adaptive":
        mn = params.find_one_int("minsamples", 4)
        mx = params.find_one_int("maxsamples", 32)
        method = params.find_one_string("method", "contrast")
        if method not in ("contrast", "shapeid"):
            warning(f'Adaptive sampling metric "{method}" unknown. Using "contrast".')
            method = "contrast"
        if quick:
            mn, mx = 1, 2
        sp = SamplerSpec(S_ADAPTIVE, _round_pow2(mx), adaptive_min=mn, adaptive_max=mx,
                         adaptive_method=method)
    else:
        warning(f'Sampler "{name}" unknown; using "lowdiscrepancy".')
        return make_sampler("lowdiscrepancy", params, options)
    params.report_unused(f'in sampler "{name}"')
    return sp


class CameraSamples(NamedTuple):
    px: torch.Tensor       # [N] continuous raster x
    py: torch.Tensor       # [N]
    u_lens1: torch.Tensor  # [N]
    u_lens2: torch.Tensor
    u_time: torch.Tensor
    pixel: torch.Tensor    # [N] int64 flat pixel index


@functools.lru_cache(maxsize=8)
def _bc_buckets(spp: int):
    """Bucket the best-candidate table into a [W*W, spp, 2] per-pixel
    layout (NumPy): the table tiles a W x W pixel window with ~spp
    points per pixel; short cells keep jittered points from
    RandomState(11), as in the JAX package."""
    pts = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "bestcandidate.npy"))  # [N, 2] in [0,1)^2
    n = len(pts)
    w = max(1, int(np.sqrt(n / max(spp, 1))))
    cell = np.minimum((pts * w).astype(np.int64), w - 1)
    cid = cell[:, 0] * w + cell[:, 1]
    frac = pts * w - cell                     # offset within the pixel
    out = np.random.RandomState(11).rand(w * w, spp, 2).astype(np.float32)
    counts = np.zeros(w * w, np.int64)
    for i in range(n):
        c = cid[i]
        if counts[c] < spp:
            out[c, counts[c]] = frac[i]
            counts[c] += 1
    return w, out


@functools.lru_cache(maxsize=8)
def _bc_buckets_on(spp: int, device):
    w, out = _bc_buckets(spp)
    return w, torch.as_tensor(out, device=device)


def _wang_hash(x):
    """uint32 mixer (held in int64) for per-pixel scrambles."""
    x = (x ^ 61) ^ (x >> 16)
    x = mul32(x, 9)
    x = x ^ (x >> 4)
    x = mul32(x, 0x27D4EB2D)
    return x ^ (x >> 15)


def camera_samples(spec: SamplerSpec, pix_x, pix_y, width: int, seed: int = 0) -> CameraSamples:
    """spec.spp camera samples for each pixel of the batch.

    pix_x/pix_y: [P] integer pixel coords. Returns flat tensors
    [P * spp], sample-major per pixel. Deterministic in (pixel, seed).
    """
    P = pix_x.shape[0]
    spp = spec.spp
    dev = pix_x.device
    pid = pix_y.long() * width + pix_x.long()
    pix_xf = torch.repeat_interleave(pix_x.to(torch.float32), spp)
    pix_yf = torch.repeat_interleave(pix_y.to(torch.float32), spp)
    pid_r = torch.repeat_interleave(pid, spp)
    sidx = torch.arange(spp, dtype=torch.int64, device=dev).repeat(P)
    base = _wang_hash((pid_r + ((seed * 0x9E3779B9) & M32)) & M32)

    if spec.kind == S_BESTCANDIDATE:
        # the tiled table: pixel (x, y) indexes its cell of the W x W
        # tile; the in-pixel offsets come straight from the table
        w, buckets = _bc_buckets_on(spp, dev)
        cid = torch.repeat_interleave((pix_x.long() % w) * w + (pix_y.long() % w), spp)
        pt = buckets[cid, sidx]                       # [P*spp, 2]
        sx, sy = pt[:, 0], pt[:, 1]
        l1 = van_der_corput(sidx, _wang_hash((base + 0x02E5BE93) & M32))
        l2 = _uniform(base, sidx, 3)
        tm = van_der_corput(sidx, _wang_hash((base + 0x368CC8B7) & M32))
    elif spec.kind == S_LOWDISCREPANCY:
        sx = van_der_corput(sidx, base)
        sy = sobol2(sidx, _wang_hash((base + 0x68BC21EB) & M32))
        l1 = van_der_corput(sidx, _wang_hash((base + 0x02E5BE93) & M32))
        l2 = sobol2(sidx, _wang_hash((base + 0x967A889B) & M32))
        tm = van_der_corput(sidx, _wang_hash((base + 0x368CC8B7) & M32))
    elif spec.kind == S_STRATIFIED or spec.kind == S_ADAPTIVE:
        nx = spec.nx if spec.kind == S_STRATIFIED else _round_pow2(int(np.sqrt(spp)))
        ny = max(1, spp // max(nx, 1))
        nx = max(nx, 1)
        ix = (sidx % nx).to(torch.float32)
        iy = ((sidx // nx) % max(ny, 1)).to(torch.float32)
        if spec.jitter:
            jx = _uniform(base, sidx, 0)
            jy = _uniform(base, sidx, 1)
        else:
            jx = jy = torch.full_like(ix, 0.5)
        sx = (ix + jx) / nx
        sy = (iy + jy) / max(ny, 1)
        l1 = _uniform(base, sidx, 2)
        l2 = _uniform(base, sidx, 3)
        tm = _uniform(base, sidx, 4)
    elif spec.kind == S_HALTON:
        # global index in int32, wrapping as the JAX package's does
        gidx = ((pid_r * spp + sidx + 2 ** 31) & M32) - 2 ** 31
        h = halton_nd(gidx, 5)
        # Cranley-Patterson rotation per pixel to decorrelate
        zero = torch.zeros_like(sidx)
        sx = torch.remainder(h[..., 0] + _uniform(base, zero, 0), 1.0)
        sy = torch.remainder(h[..., 1] + _uniform(base, zero, 1), 1.0)
        l1, l2, tm = h[..., 2], h[..., 3], h[..., 4]
    else:  # RANDOM
        sx = _uniform(base, sidx, 0)
        sy = _uniform(base, sidx, 1)
        l1 = _uniform(base, sidx, 2)
        l2 = _uniform(base, sidx, 3)
        tm = _uniform(base, sidx, 4)

    return CameraSamples(px=pix_xf + sx, py=pix_yf + sy, u_lens1=l1,
                         u_lens2=l2, u_time=tm, pixel=pid_r)


def _uniform(base, sidx, dim: int):
    """Counter-based uniform in [0,1): hash(base, sample, dim)."""
    h = _wang_hash(base ^ mul32(sidx, 0x85EBCA6B) ^ ((dim * 0xC2B2AE35) & M32))
    return u32_to_unit(h)


def integrator_uniform(pixel, sample_idx, depth: int, dim: int, seed: int = 0):
    """Per-lane uniform for integrator decisions, keyed by
    (pixel, sample, depth, dim): the reference's Sample 1D/2D request
    arrays replaced by on-demand deterministic streams. pixel and
    sample_idx are int64 tensors of uint32 values."""
    return integrator_uniform_at(integrator_base(pixel, sample_idx, seed), depth, dim)


def integrator_base(pixel, sample_idx, seed: int = 0):
    """The per-lane hash of (pixel, sample, seed) that every draw of
    integrator_uniform starts from: hashed once, it keeps the seed out
    of the draws."""
    return _wang_hash(pixel ^ mul32(sample_idx, 0x9E3779B9) ^ ((seed * 0x51633E2D) & M32))


def integrator_uniform_at(base, depth: int, dim: int):
    """integrator_uniform's draw (depth, dim) from integrator_base."""
    dmix = ((depth * 0x68BC21EB) + (dim * 0x02E5BE93)) & M32
    return u32_to_unit(_wang_hash(base ^ dmix))


# --- adaptive sampler veto (reference samplers/adaptive.cpp) ---------------

ADAPTIVE_MAX_CONTRAST = 0.5


def adaptive_needs(y, n_pix: int, spp: int):
    """Contrast veto: per pixel, True when any of its spp sample
    luminances deviates from their mean by more than
    ADAPTIVE_MAX_CONTRAST (relative) and the mean is positive: those
    pixels re-render at maxsamples and these samples are discarded."""
    ys = y.reshape(n_pix, spp)
    mean = torch.mean(ys, 1, keepdim=True)
    contrast = torch.abs(ys - mean) / torch.clamp(mean, min=1e-9)
    return torch.any(contrast > ADAPTIVE_MAX_CONTRAST, 1) & (mean[:, 0] > 0)


def adaptive_needs_shapeid(prim, n_pix: int, spp: int):
    """Shape-id veto (reference samplers/adaptive.cpp:182-185): a pixel
    whose minsamples hit different primitives, or mix hits and misses
    (prim -1), is supersampled."""
    ps = prim.reshape(n_pix, spp)
    return torch.any(ps != ps[:, :1], 1)
