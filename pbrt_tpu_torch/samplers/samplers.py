"""Pixel samplers: batched camera-sample generation.

Port of pbrt_tpu/samplers/samplers.py for the stratified,
lowdiscrepancy and random kinds. All samples for a pixel batch are
generated at once as flat tensors, from counter-based hashes of
(pixel, sample, dimension, seed): the streams are bit-identical to the
JAX package's (uint32 arithmetic in int64, masked after every step).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from pbrt_tpu_torch.core.error import PbrtError, warning
from pbrt_tpu_torch.core.sampling import M32, mul32, sobol2, u32_to_unit, van_der_corput
from pbrt_tpu_torch.scene.paramset import ParamSet

S_STRATIFIED, S_LOWDISCREPANCY, S_RANDOM = 0, 1, 3  # ids as in pbrt_tpu


def _round_pow2(n: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, n)))))


@dataclass
class SamplerSpec:
    kind: int
    spp: int
    jitter: bool = True
    nx: int = 2            # stratified strata
    ny: int = 2


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
    elif name == "lowdiscrepancy":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        sp = SamplerSpec(S_LOWDISCREPANCY, _round_pow2(ps))
    elif name == "random":
        ps = params.find_one_int("pixelsamples", 4)
        if quick:
            ps = 1
        sp = SamplerSpec(S_RANDOM, ps)
    elif name in ("halton", "bestcandidate", "adaptive"):
        raise PbrtError(f'not yet ported: sampler "{name}"')
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

    if spec.kind == S_LOWDISCREPANCY:
        sx = van_der_corput(sidx, base)
        sy = sobol2(sidx, _wang_hash((base + 0x68BC21EB) & M32))
        l1 = van_der_corput(sidx, _wang_hash((base + 0x02E5BE93) & M32))
        l2 = sobol2(sidx, _wang_hash((base + 0x967A889B) & M32))
        tm = van_der_corput(sidx, _wang_hash((base + 0x368CC8B7) & M32))
    elif spec.kind == S_STRATIFIED:
        nx = spec.nx
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
    base = _wang_hash(pixel ^ mul32(sample_idx, 0x9E3779B9)
                      ^ ((seed * 0x51633E2D) & M32))
    dmix = ((depth * 0x68BC21EB) + (dim * 0x02E5BE93)) & M32
    return u32_to_unit(_wang_hash(base ^ dmix))
