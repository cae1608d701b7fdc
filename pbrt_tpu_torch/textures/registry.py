"""Texture descriptors: host objects whose eval() runs torch ops per hit batch.

Port of pbrt_tpu/textures/registry.py (reference core/texture.{h,cpp},
textures/*.cpp, api.cpp:418-483 dispatch). The texture graph of a scene
is static, so evaluation is plain Python recursion over descriptors.
Float textures eval to [H]; spectrum textures to [H, N_BINS], on the
device of the hit batch.

ShadingGeom carries the per-hit fields textures consume (world p, uv,
and screen-space differentials for antialiasing). At render time the
integrators build it with `ShadingGeom.at`, which sets every
differential to zero, as the JAX package does: lookups point-sample
(an image map reads its finest level, the closed-form checkerboard
does no antialiasing).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import warning
from pbrt_tpu_torch.core.geometry import length, normalize
from pbrt_tpu_torch.core.transform import Transform, xform_point_affine, xform_vector
from pbrt_tpu_torch.textures import noise as perlin


class ShadingGeom(NamedTuple):
    p: torch.Tensor       # [H, 3] world-space point
    uv: torch.Tensor      # [H, 2]
    dpdx: torch.Tensor    # [H, 3] screen-space differentials (may be zeros)
    dpdy: torch.Tensor    # [H, 3]
    duvdx: torch.Tensor   # [H, 2]
    duvdy: torch.Tensor   # [H, 2]

    @staticmethod
    def at(p, uv=None):
        h = p.shape[:-1]
        z3 = torch.zeros(h + (3,), device=p.device)
        z2 = torch.zeros(h + (2,), device=p.device)
        return ShadingGeom(p, uv if uv is not None else z2, z3, z3, z2, z2)


class _DeviceCache:
    """Per-device copies of a descriptor's host (NumPy) constants."""

    def _on(self, name: str, device) -> torch.Tensor:
        cache = self.__dict__.setdefault("_dev_cache", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(np.array(getattr(self, name)), device=device)
        return cache[key]


def _spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def _spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


# ---------------------------------------------------------------------------
# 2D / 3D mappings (reference core/texture.h TextureMapping2D/3D)

class UVMapping2D:
    def __init__(self, su=1.0, sv=1.0, du=0.0, dv=0.0):
        self.su, self.sv, self.du, self.dv = su, sv, du, dv

    def map(self, sg: ShadingGeom):
        s = self.su * sg.uv[..., 0] + self.du
        t = self.sv * sg.uv[..., 1] + self.dv
        dsdx = self.su * sg.duvdx[..., 0]
        dtdx = self.sv * sg.duvdx[..., 1]
        dsdy = self.su * sg.duvdy[..., 0]
        dtdy = self.sv * sg.duvdy[..., 1]
        return s, t, dsdx, dtdx, dsdy, dtdy


class SphericalMapping2D(_DeviceCache):
    def __init__(self, w2t: Transform):
        self.w2t = np.asarray(w2t.m, np.float32)

    def _sphere(self, p):
        v = normalize(xform_point_affine(self._on("w2t", p.device), p))
        return _spherical_theta(v) * (1.0 / math.pi), _spherical_phi(v) * (1.0 / (2.0 * math.pi))

    def map(self, sg: ShadingGeom):
        s, t = self._sphere(sg.p)
        delta = 0.1
        sx, tx = self._sphere(sg.p + delta * sg.dpdx)
        sy, ty = self._sphere(sg.p + delta * sg.dpdy)
        dsdx, dtdx = (sx - s) / delta, (tx - t) / delta
        dsdy, dtdy = (sy - s) / delta, (ty - t) / delta
        # handle the phi seam
        dtdx = torch.where(dtdx > 0.5, 1.0 - dtdx, torch.where(dtdx < -0.5, -(dtdx + 1), dtdx))
        dtdy = torch.where(dtdy > 0.5, 1.0 - dtdy, torch.where(dtdy < -0.5, -(dtdy + 1), dtdy))
        return s, t, dsdx, dtdx, dsdy, dtdy


class CylindricalMapping2D(_DeviceCache):
    def __init__(self, w2t: Transform):
        self.w2t = np.asarray(w2t.m, np.float32)

    def _cyl(self, p):
        v = normalize(xform_point_affine(self._on("w2t", p.device), p))
        return (math.pi + torch.atan2(v[..., 1], v[..., 0])) / (2.0 * math.pi), v[..., 2]

    def map(self, sg: ShadingGeom):
        s, t = self._cyl(sg.p)
        delta = 0.01
        sx, tx = self._cyl(sg.p + delta * sg.dpdx)
        sy, ty = self._cyl(sg.p + delta * sg.dpdy)
        return s, t, (sx - s) / delta, (tx - t) / delta, (sy - s) / delta, (ty - t) / delta


class PlanarMapping2D(_DeviceCache):
    def __init__(self, vs, vt, ds=0.0, dt=0.0):
        self.vs = np.asarray(vs, np.float32)
        self.vt = np.asarray(vt, np.float32)
        self.ds, self.dt = ds, dt

    def map(self, sg: ShadingGeom):
        vs, vt = self._on("vs", sg.p.device), self._on("vt", sg.p.device)
        s = self.ds + torch.sum(sg.p * vs, -1)
        t = self.dt + torch.sum(sg.p * vt, -1)
        dsdx = torch.sum(sg.dpdx * vs, -1)
        dtdx = torch.sum(sg.dpdx * vt, -1)
        dsdy = torch.sum(sg.dpdy * vs, -1)
        dtdy = torch.sum(sg.dpdy * vt, -1)
        return s, t, dsdx, dtdx, dsdy, dtdy


class IdentityMapping3D(_DeviceCache):
    def __init__(self, w2t: Transform):
        self.w2t = np.asarray(w2t.m, np.float32)

    def map(self, sg: ShadingGeom):
        m = self._on("w2t", sg.p.device)
        return (xform_point_affine(m, sg.p), xform_vector(m, sg.dpdx),
                xform_vector(m, sg.dpdy))


def _make_mapping_2d(tex2world: Transform, tp) -> object:
    mtype = tp.find_string("mapping", "uv")
    if mtype == "uv":
        return UVMapping2D(
            tp.find_float("uscale", 1.0), tp.find_float("vscale", 1.0),
            tp.find_float("udelta", 0.0), tp.find_float("vdelta", 0.0),
        )
    if mtype == "spherical":
        return SphericalMapping2D(tex2world.inverse())
    if mtype == "cylindrical":
        return CylindricalMapping2D(tex2world.inverse())
    if mtype == "planar":
        return PlanarMapping2D(
            tp.find_vector("v1", [1, 0, 0]), tp.find_vector("v2", [0, 1, 0]),
            tp.find_float("udelta", 0.0), tp.find_float("vdelta", 0.0),
        )
    warning(f'2D texture mapping "{mtype}" unknown')
    return UVMapping2D()


def _lerp_by(amt, v1, v2):
    """(1 - amt) v1 + amt v2, with a float amount [H] spread over the
    spectral axis of spectral values."""
    if v1.dim() > amt.dim():
        amt = amt[..., None]
    return (1.0 - amt) * v1 + amt * v2


def _parity(a, b, c=None):
    """(floor(a) + floor(b) [+ floor(c)]) mod 2 as 0.0 / 1.0 (int32
    lattice coordinates, as in the JAX package)."""
    k = torch.floor(a).to(torch.int32) + torch.floor(b).to(torch.int32)
    if c is not None:
        k = k + torch.floor(c).to(torch.int32)
    return torch.remainder(k, 2).to(torch.float32)


# ---------------------------------------------------------------------------
# Texture descriptors

class Texture:
    spectral: bool = False

    def eval(self, sg: ShadingGeom):
        raise NotImplementedError

    def mean(self) -> float:
        """Rough average value (for light-power estimates)."""
        return 1.0


class ConstantTexture(Texture, _DeviceCache):
    def __init__(self, value):
        self.value = np.asarray(value, np.float32)
        self.spectral = self.value.ndim > 0

    def eval(self, sg: ShadingGeom):
        v = self._on("value", sg.p.device)
        return v.expand(sg.p.shape[:-1] + tuple(v.shape))

    def mean(self):
        return float(np.mean(self.value))


class ScaleTexture(Texture):
    def __init__(self, tex1: Texture, tex2: Texture):
        self.tex1, self.tex2 = tex1, tex2
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        v1, v2 = self.tex1.eval(sg), self.tex2.eval(sg)
        if v1.dim() < v2.dim():
            v1 = v1[..., None]
        elif v2.dim() < v1.dim():
            v2 = v2[..., None]
        return v1 * v2

    def mean(self):
        return self.tex1.mean() * self.tex2.mean()


class MixTexture(Texture):
    def __init__(self, tex1: Texture, tex2: Texture, amount: Texture):
        self.tex1, self.tex2, self.amount = tex1, tex2, amount
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        return _lerp_by(self.amount.eval(sg), self.tex1.eval(sg), self.tex2.eval(sg))


class BilerpTexture(Texture, _DeviceCache):
    def __init__(self, mapping, v00, v01, v10, v11, spectral: bool):
        self.mapping = mapping
        self.v00, self.v01 = np.asarray(v00, np.float32), np.asarray(v01, np.float32)
        self.v10, self.v11 = np.asarray(v10, np.float32), np.asarray(v11, np.float32)
        self.spectral = spectral

    def eval(self, sg):
        s, t, *_ = self.mapping.map(sg)
        if self.spectral:
            s, t = s[..., None], t[..., None]
        dev = sg.p.device
        return ((1 - s) * (1 - t) * self._on("v00", dev) + (1 - s) * t * self._on("v01", dev)
                + s * (1 - t) * self._on("v10", dev) + s * t * self._on("v11", dev))


class UVTexture(Texture):
    spectral = True

    def __init__(self, mapping):
        self.mapping = mapping

    def eval(self, sg):
        s, t, *_ = self.mapping.map(sg)
        rgb = torch.stack([s - torch.floor(s), t - torch.floor(t), torch.zeros_like(s)], -1)
        return spec.from_rgb(rgb)


def _bump_int(x):
    """Integral of the 1D checkerboard step (reference checkerboard.h)."""
    return torch.floor(x / 2.0) + 2.0 * torch.clamp(x / 2.0 - torch.floor(x / 2.0) - 0.5,
                                                    min=0.0)


class CheckerboardTexture2D(Texture):
    def __init__(self, mapping, tex1: Texture, tex2: Texture, aamode: str = "closedform"):
        self.mapping, self.tex1, self.tex2 = mapping, tex1, tex2
        self.aamode = aamode
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        s, t, dsdx, dtdx, dsdy, dtdy = self.mapping.map(sg)
        v1, v2 = self.tex1.eval(sg), self.tex2.eval(sg)
        point_check = _parity(s, t)
        if self.aamode == "closedform":
            zero = torch.zeros((), device=s.device)
            ds = torch.maximum(torch.abs(dsdx), torch.abs(dsdy))
            dt = torch.maximum(torch.abs(dtdx), torch.abs(dtdy))
            s0, s1 = s - ds, s + ds
            t0, t1 = t - dt, t + dt
            sint = torch.where(ds > 0, (_bump_int(s1) - _bump_int(s0))
                               / (2.0 * torch.clamp(ds, min=1e-20)), zero)
            tint = torch.where(dt > 0, (_bump_int(t1) - _bump_int(t0))
                               / (2.0 * torch.clamp(dt, min=1e-20)), zero)
            amt = torch.clamp(sint + tint - 2.0 * sint * tint, 0.0, 1.0)
            filtered = (torch.abs(dsdx) + torch.abs(dsdy) + torch.abs(dtdx)
                        + torch.abs(dtdy)) > 1e-12
            amt = torch.where(filtered, amt, point_check)
        else:
            amt = point_check
        return _lerp_by(amt, v1, v2)

    def mean(self):
        return 0.5 * (self.tex1.mean() + self.tex2.mean())


class CheckerboardTexture3D(Texture):
    def __init__(self, mapping: IdentityMapping3D, tex1: Texture, tex2: Texture):
        self.mapping, self.tex1, self.tex2 = mapping, tex1, tex2
        self.spectral = tex1.spectral or tex2.spectral

    def eval(self, sg):
        p, _, _ = self.mapping.map(sg)
        amt = _parity(p[..., 0], p[..., 1], p[..., 2])
        return _lerp_by(amt, self.tex1.eval(sg), self.tex2.eval(sg))


class DotsTexture(Texture):
    def __init__(self, mapping, inside: Texture, outside: Texture):
        self.mapping, self.inside, self.outside = mapping, inside, outside
        self.spectral = inside.spectral or outside.spectral

    def eval(self, sg):
        s, t, *_ = self.mapping.map(sg)
        s_cell, t_cell = torch.floor(s + 0.5), torch.floor(t + 0.5)
        half = torch.full_like(s_cell, 0.5)
        has_dot = perlin.noise(torch.stack([s_cell, t_cell, half], -1)) > 0.0
        rad, maxshift = 0.35, 0.5 - 0.35
        s_center = s_cell + maxshift * perlin.noise(
            torch.stack([s_cell + 1.5, t_cell + 2.8, half], -1))
        t_center = t_cell + maxshift * perlin.noise(
            torch.stack([s_cell + 4.5, t_cell + 9.8, half], -1))
        ds, dt = s - s_center, t - t_center
        m = has_dot & (ds * ds + dt * dt < rad * rad)
        vi, vo = self.inside.eval(sg), self.outside.eval(sg)
        if vi.dim() > m.dim():
            m = m[..., None]
        return torch.where(m, vi, vo)


class FBmTexture(Texture):
    def __init__(self, mapping: IdentityMapping3D, octaves: int, roughness: float):
        self.mapping, self.octaves, self.roughness = mapping, octaves, roughness

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        return perlin.fbm(p, length(dpdx), length(dpdy), self.roughness, self.octaves)


class WrinkledTexture(Texture):
    def __init__(self, mapping: IdentityMapping3D, octaves: int, roughness: float):
        self.mapping, self.octaves, self.roughness = mapping, octaves, roughness

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        return perlin.turbulence(p, length(dpdx), length(dpdy), self.roughness, self.octaves)


class WindyTexture(Texture):
    def __init__(self, mapping: IdentityMapping3D):
        self.mapping = mapping

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        wind = perlin.fbm(0.1 * p, 0.1 * length(dpdx), 0.1 * length(dpdy), 0.5, 3)
        wave = perlin.fbm(p, length(dpdx), length(dpdy), 0.5, 6)
        return torch.abs(wind) * wave


_MARBLE_COLORS = np.array(
    [
        [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
        [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
        [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6],
    ],
    np.float32,
)


class MarbleTexture(Texture, _DeviceCache):
    spectral = True
    colors = _MARBLE_COLORS

    def __init__(self, mapping: IdentityMapping3D, octaves: int, roughness: float,
                 scale: float, variation: float):
        self.mapping, self.octaves, self.roughness = mapping, octaves, roughness
        self.scale, self.variation = scale, variation

    def eval(self, sg):
        p, dpdx, dpdy = self.mapping.map(sg)
        p = p * self.scale
        marble = p[..., 1] + self.variation * perlin.fbm(
            p, self.scale * length(dpdx), self.scale * length(dpdy),
            self.roughness, self.octaves)
        t = 0.5 + 0.5 * torch.sin(marble)
        # cubic spline through the marble color ramp (the reference's
        # repeated lerp)
        nseg = _MARBLE_COLORS.shape[0] - 3
        ti = torch.clamp((t * nseg).to(torch.int32), 0, nseg - 1)
        tt = t * nseg - ti
        c = self._on("colors", sg.p.device)
        ti = ti.to(torch.int64)
        c0, c1, c2, c3 = c[ti], c[ti + 1], c[ti + 2], c[ti + 3]
        s0 = (1 - tt)[..., None]
        s1 = tt[..., None]
        d0 = s0 * c0 + s1 * c1
        d1 = s0 * c1 + s1 * c2
        d2 = s0 * c2 + s1 * c3
        e0 = s0 * d0 + s1 * d1
        e1 = s0 * d1 + s1 * d2
        return spec.from_rgb(1.5 * (s0 * e0 + s1 * e1))


class ImageMapTexture(Texture, _DeviceCache):
    """MIPMap'd image texture (reference textures/imagemap.cpp,
    core/mipmap.h). EWA filtering by default (core/mipmap.h:50-97),
    trilinear when the scene asks for it. The EWA form is the JAX
    package's: a fixed number of Gaussian-weighted bilinear taps along
    the footprint's major axis, at the mip level the minor axis sets.

    The pyramid lives on the device as one flat [texels, 3] tensor with
    per-level offsets and sizes, uploaded once per device; a lookup
    gathers only the two levels it blends."""

    _cache: dict = {}      # (filename, gamma) -> host image
    N_EWA_TAPS = 8

    def __init__(self, mapping, filename: str, spectral: bool, trilinear=True,
                 max_aniso=8.0, wrap="repeat", scale=1.0, gamma=1.0):
        self.mapping = mapping
        self.spectral = spectral
        self.wrap = wrap
        self.scale = scale
        self.trilinear = bool(trilinear)
        self.max_aniso = float(max(max_aniso, 1.0))
        key = (filename, gamma)
        if key in ImageMapTexture._cache:
            img = ImageMapTexture._cache[key]
        else:
            try:
                from pbrt_tpu_torch.io.image import read_image

                img = read_image(filename).astype(np.float32)
            except (OSError, ValueError, ImportError, KeyError, NotImplementedError) as e:
                # reference textures/imagemap.cpp:78-80: missing file ->
                # single WHITE texel (times scale/gamma applied later)
                warning(f'Couldn\'t read image "{filename}": {e}; using white texel')
                img = np.ones((1, 1, 3), np.float32)
            if gamma != 1.0:
                img = np.power(np.maximum(img, 0.0), gamma)
            ImageMapTexture._cache[key] = img
        self.levels = self._build_pyramid(img)
        self._mean = float(img.mean())
        # the pyramid packed flat for the device: [texels, C] and per level
        # its first texel, height and width
        self.flat = np.concatenate([lv.reshape(-1, lv.shape[-1]) for lv in self.levels])
        self.offs = np.cumsum([0] + [lv.shape[0] * lv.shape[1] for lv in self.levels[:-1]])
        self.hs = np.asarray([lv.shape[0] for lv in self.levels], np.int64)
        self.ws = np.asarray([lv.shape[1] for lv in self.levels], np.int64)

    @staticmethod
    def _build_pyramid(img):
        """Host pyramid by 2x2 box means (NumPy, the JAX package's math).
        Once one side is down to 1 texel the other keeps halving by 1x2
        means (the JAX package fails on such non-square images)."""
        levels = [img]
        cur = img
        while max(cur.shape[0], cur.shape[1]) > 1:
            fy, fx = min(2, cur.shape[0]), min(2, cur.shape[1])
            h, w = cur.shape[0] // fy, cur.shape[1] // fx
            cur = cur[: fy * h, : fx * w].reshape(h, fy, w, fx, -1).mean(axis=(1, 3))
            levels.append(cur)
        return levels

    def mean(self):
        return self._mean * self.scale

    def _lookup_level(self, level, s, t):
        """Bilinear lookup at per-lane mip level `level` (int64, broadcast
        against s/t) -> [..., C]."""
        dev = s.device
        flat = self._on("flat", dev)
        off = self._on("offs", dev)[level]
        h, w = self._on("hs", dev)[level], self._on("ws", dev)[level]
        x = s * w.to(torch.float32) - 0.5
        yv = t * h.to(torch.float32) - 0.5
        fx_f, fy_f = torch.floor(x), torch.floor(yv)
        x0 = fx_f.to(torch.int32).to(torch.int64)
        y0 = fy_f.to(torch.int32).to(torch.int64)
        fx = x - fx_f
        fy = yv - fy_f

        def wrap_idx(i, n):
            if self.wrap == "repeat":
                return torch.remainder(i, n)
            # "clamp", and "black" (masked below)
            return torch.minimum(torch.clamp(i, min=0), n - 1)

        def texel(xi, yi):
            v = flat[off + wrap_idx(yi, h) * w + wrap_idx(xi, w)]
            if self.wrap == "black":
                ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
                v = torch.where(ok[..., None], v, torch.zeros((), device=v.device))
            return v

        v00 = texel(x0, y0)
        v10 = texel(x0 + 1, y0)
        v01 = texel(x0, y0 + 1)
        v11 = texel(x0 + 1, y0 + 1)
        fx_, fy_ = fx[..., None], fy[..., None]
        return ((1 - fx_) * (1 - fy_) * v00 + fx_ * (1 - fy_) * v10
                + (1 - fx_) * fy_ * v01 + fx_ * fy_ * v11)

    def _two_level_lerp(self, ss, tt, l0, fl):
        """Bilinear lookups at levels l0 and l0+1, lerped by fl. ss/tt
        may carry a leading taps axis broadcast against l0/fl [H]. The
        level past the coarsest is never weighted (fl = 0 there)."""
        n_levels = len(self.levels)
        l1 = torch.clamp(l0 + 1, max=n_levels - 1)
        out0 = self._lookup_level(l0, ss, tt)
        out1 = self._lookup_level(l1, ss, tt)
        flb = fl[..., None]
        return (1 - flb) * out0 + flb * out1

    def _ewa(self, s, t, dsdx, dtdx, dsdy, dtdy):
        """Anisotropic footprint filter (reference core/mipmap.h:50-97):
        mip level from the MINOR ellipse axis (clamped to
        maxanisotropy), Gaussian-weighted taps along the MAJOR axis."""
        lx = dsdx * dsdx + dtdx * dtdx
        ly = dsdy * dsdy + dtdy * dtdy
        swap = ly > lx
        maj_s = torch.where(swap, dsdy, dsdx)
        maj_t = torch.where(swap, dtdy, dtdx)
        maj_len = torch.sqrt(torch.clamp(torch.maximum(lx, ly), min=1e-16))
        min_len = torch.sqrt(torch.clamp(torch.minimum(lx, ly), min=1e-16))
        # clamp eccentricity: majorLength / minorLength <= maxAnisotropy
        min_len = torch.maximum(min_len, maj_len / self.max_aniso)
        n_levels = len(self.levels)
        lvl = torch.clamp(n_levels - 1 + torch.log2(torch.clamp(min_len, min=1e-8)),
                          0.0, n_levels - 1)
        l0 = torch.floor(lvl)
        fl = lvl - l0
        T = self.N_EWA_TAPS
        u = (torch.arange(T, dtype=torch.float32, device=s.device) + 0.5) / T - 0.5
        w = torch.exp(-2.0 * (2.0 * u) ** 2)
        w = w / torch.sum(w)
        ub = u.reshape((T,) + (1,) * s.dim())
        taps = self._two_level_lerp(s[None] + ub * maj_s[None], t[None] + ub * maj_t[None],
                                    l0.to(torch.int64), fl)          # [T, H, C]
        return torch.sum(w.reshape((T,) + (1,) * (taps.dim() - 1)) * taps, 0)

    def eval(self, sg):
        s, t, dsdx, dtdx, dsdy, dtdy = self.mapping.map(sg)
        n_levels = len(self.levels)
        if self.trilinear:
            # isotropic width = max differential (reference mipmap.h
            # triangle-filter path)
            width = torch.maximum(torch.maximum(torch.abs(dsdx), torch.abs(dtdx)),
                                  torch.maximum(torch.abs(dsdy), torch.abs(dtdy)))
            lvl = n_levels - 1 + torch.log2(torch.clamp(width, min=1e-8))
            lvl = torch.clamp(lvl, 0.0, n_levels - 1)
            l0 = torch.floor(lvl)
            rgb = self._two_level_lerp(s, t, l0.to(torch.int64), lvl - l0) * self.scale
        else:
            rgb = self._ewa(s, t, dsdx, dtdx, dsdy, dtdy) * self.scale
        if self.spectral:
            return spec.from_rgb(rgb)
        return rgb.mean(-1)


# ---------------------------------------------------------------------------
# Factory (reference core/api.cpp:418-483 MakeFloatTexture/MakeSpectrumTexture)

def make_texture(name: str, kind: str, tex2world: Transform, tp) -> Optional[Texture]:
    spectral = kind == "spectrum"

    def tex(pname, default):
        if spectral:
            return tp.get_spectrum_texture(pname, default)
        return tp.get_float_texture(pname, default)

    if name == "constant":
        if spectral:
            return ConstantTexture(tp.find_spectrum("value", 1.0))
        return ConstantTexture(np.float32(tp.find_float("value", 1.0)))
    if name == "scale":
        return ScaleTexture(tex("tex1", 1.0), tex("tex2", 1.0))
    if name == "mix":
        t1, t2 = tex("tex1", 0.0), tex("tex2", 1.0)
        return MixTexture(t1, t2, tp.get_float_texture("amount", 0.5))
    if name == "bilerp":
        m = _make_mapping_2d(tex2world, tp)
        find = tp.find_spectrum if spectral else tp.find_float
        return BilerpTexture(m, find("v00", 0.0), find("v01", 1.0), find("v10", 0.0),
                             find("v11", 1.0), spectral)
    if name == "uv":
        return UVTexture(_make_mapping_2d(tex2world, tp))
    if name == "checkerboard":
        dim = tp.find_int("dimension", 2)
        t1, t2 = tex("tex1", 1.0), tex("tex2", 0.0)
        if dim == 3:
            return CheckerboardTexture3D(IdentityMapping3D(tex2world.inverse()), t1, t2)
        aa = tp.find_string("aamode", "closedform")
        return CheckerboardTexture2D(_make_mapping_2d(tex2world, tp), t1, t2, aa)
    if name == "dots":
        ti, to = tex("inside", 1.0), tex("outside", 0.0)
        return DotsTexture(_make_mapping_2d(tex2world, tp), ti, to)
    if name == "fbm":
        return FBmTexture(IdentityMapping3D(tex2world.inverse()),
                          tp.find_int("octaves", 8), tp.find_float("roughness", 0.5))
    if name == "wrinkled":
        return WrinkledTexture(IdentityMapping3D(tex2world.inverse()),
                               tp.find_int("octaves", 8), tp.find_float("roughness", 0.5))
    if name == "windy":
        return WindyTexture(IdentityMapping3D(tex2world.inverse()))
    if name == "marble":
        return MarbleTexture(IdentityMapping3D(tex2world.inverse()),
                             tp.find_int("octaves", 8), tp.find_float("roughness", 0.5),
                             tp.find_float("scale", 1.0), tp.find_float("variation", 0.2))
    if name == "imagemap":
        m = _make_mapping_2d(tex2world, tp)
        fn = tp.find_filename("filename", "")
        gamma = tp.find_float("gamma", 2.2 if fn.lower().endswith((".tga", ".png")) else 1.0)
        return ImageMapTexture(
            m, fn, spectral,
            trilinear=tp.find_bool("trilinear", False),
            max_aniso=tp.find_float("maxanisotropy", 8.0),
            wrap=tp.find_string("wrap", "repeat"),
            scale=tp.find_float("scale", 1.0),
            gamma=gamma,
        )
    warning(f'Texture "{name}" unknown.')
    return None
