"""Plain reference for the matte triangle-mesh scenes: a path tracer in
plain PyTorch that renders chosen pixels of chosen frames.

It imports nothing of the renderer it checks and takes nothing the
renderer made: the benchmark hands it the same triangles, colours,
light and camera poses it hands the renderer, and it builds its own
spectra, rays and hits from them. What it computes is the algorithm the
renderer states for this scene class (pbrt-v2's PathIntegrator as the
renderer defines it):

- the camera: pbrt-v2's perspective projection, one ray per camera
  sample through the pinhole, the screen window [-1, 1] on the short
  axis;
- the samples: the renderer's counter-based streams, a Wang hash of
  (pixel, sample index, frame seed), the pixel offset by the scrambled
  (0,2)-sequence, and each bounce's numbers by a hash of (pixel,
  sample, bounce, dimension). They are copied here so that each path
  can be followed pixel by pixel;
- the path: up to `maxdepth` vertices; at each, one light sampled by
  power (one point light: picked with probability 1), its contribution
  f * I / d^2 * |cos| unless a shadow ray from p + 1e-3 wi to within
  (1 - 1e-3) of the light is blocked; the next direction by cosine
  sampling of the concentric disk in the frame (ss = e1 / |e1|, ts =
  ng x ss, ng = (e1 x e2) / |e1 x e2|), flipped into wo's hemisphere;
  Russian roulette from bounce 3 with survival min(1, max(0.05,
  Y(new throughput) / Y(old))) against dimension 8; the next ray from
  p + 1e-3 wi;
- the film: a box filter of half-width 0.5, so a sample lands in its
  own pixel; XYZ -> linear RGB by pbrt-v2's matrix, clamped at 0.

Spectra are 30 bins of 400-700 nm; an RGB becomes a spectrum by Smits'
basis mixing (pbrt-v2's SampledSpectrum::FromRGB, reflectance tables,
times 0.94); a light's scale defaults to the white spectrum.

Hits come from Moller-Trumbore tests against every triangle of every
block of `BLOCK` triangles whose (padded) box the ray enters; the closest
valid t wins, the lowest triangle index on a tie. Everything runs in
`dtype`: float32 for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import spectral_tables as st

M32 = 0xFFFFFFFF
N_BINS = 30
LAMBDA_START, LAMBDA_END = 400.0, 700.0
RAY_EPS = 1e-3
BIG = 1e30
BLOCK = 256          # triangles a block
PAIR_CHUNK = 1 << 15  # (ray, block) pairs tested at once
RR_START = 3

XYZ_TO_RGB = np.array([[3.240479, -1.537150, -0.498535],
                       [-0.969256, 1.875991, 0.041556],
                       [0.055648, -0.204043, 1.057311]])
_REFL_BASIS = np.stack([st.RGBRefl2SpectWhite_BINS, st.RGBRefl2SpectCyan_BINS,
                        st.RGBRefl2SpectMagenta_BINS, st.RGBRefl2SpectYellow_BINS,
                        st.RGBRefl2SpectRed_BINS, st.RGBRefl2SpectGreen_BINS,
                        st.RGBRefl2SpectBlue_BINS]) * 0.94
_CIE = np.stack([st.CIE_X_BINS, st.CIE_Y_BINS, st.CIE_Z_BINS])
S2XYZ = _CIE * ((LAMBDA_END - LAMBDA_START) / (st.CIE_Y_INTEGRAL * N_BINS))  # [3, 30]


def rgb_to_spectrum(rgb) -> np.ndarray:
    """Smits' reflectance mixing (pbrt-v2 core/spectrum.cpp:154-243): the
    smallest channel in white, the middle minus the smallest in the
    secondary that holds both, the largest minus the middle in its primary."""
    r, g, b = (float(x) for x in rgb)
    white, cyan, magenta, yellow, red, green, blue = range(7)
    c = np.zeros(7)
    if r <= g and r <= b:
        c[white] = r
        if g <= b:
            c[cyan], c[blue] = g - r, b - g
        else:
            c[cyan], c[green] = b - r, g - b
    elif g <= r and g <= b:
        c[white] = g
        if r <= b:
            c[magenta], c[blue] = r - g, b - r
        else:
            c[magenta], c[red] = b - g, r - b
    else:
        c[white] = b
        if r <= g:
            c[yellow], c[green] = r - b, g - r
        else:
            c[yellow], c[red] = g - b, r - g
    return np.clip(c @ _REFL_BASIS, 0.0, None)


# ---------------------------------------------------------------------------
# Random streams (uint32 arithmetic held in int64)

def mul32(x, c: int):
    return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def wang_hash(x):
    x = (x ^ 61) ^ (x >> 16)
    x = mul32(x, 9)
    x = x ^ (x >> 4)
    x = mul32(x, 0x27D4EB2D)
    return x ^ (x >> 15)


def to_unit(bits, dtype):
    """Top 24 bits of a uint32 -> [0, 1)."""
    return ((bits >> 8).to(torch.float64) / float(1 << 24)).to(dtype)


def reverse_bits(n):
    out = torch.zeros_like(n)
    for i in range(32):
        out = out | (((n >> i) & 1) << (31 - i))
    return out


def sobol2_bits(n, scramble):
    v = 1 << 31
    out = scramble.clone()
    for i in range(32):
        out = torch.where(((n >> i) & 1) > 0, out ^ v, out)
        v = v ^ (v >> 1)
    return out


def pixel_offsets(pid, sidx, seed, dtype):
    """The (0,2)-sequence offsets of sample sidx in pixel pid."""
    base = wang_hash((pid + ((seed * 0x9E3779B9) & M32)) & M32)
    sx = to_unit(reverse_bits(sidx) ^ base, dtype)
    sy = to_unit(sobol2_bits(sidx, wang_hash((base + 0x68BC21EB) & M32)), dtype)
    return sx, sy


def bounce_uniform(pid, sidx, seed, depth: int, dim: int, dtype):
    base = wang_hash(pid ^ mul32(sidx, 0x9E3779B9) ^ ((seed * 0x51633E2D) & M32))
    return to_unit(wang_hash(base ^ ((depth * 0x68BC21EB + dim * 0x02E5BE93) & M32)), dtype)


# ---------------------------------------------------------------------------
# Geometry

def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def dot(a, b):
    return (a * b).sum(-1)


def unit(v):
    return v / torch.sqrt(dot(v, v)).clamp(min=1e-30)[..., None]


def look_at(eye, look, up):
    """Camera-to-world rotation columns (left, up, dir) of pbrt-v2's LookAt."""
    eye, look, up = (np.asarray(x, np.float64) for x in (eye, look, up))
    d = (look - eye) / np.linalg.norm(look - eye)
    left = np.cross(up / np.linalg.norm(up), d)
    left /= np.linalg.norm(left)
    return np.stack([left, np.cross(d, left), d], 1)


def concentric_disk(u1, u2):
    """pbrt-v2 ConcentricSampleDisk (core/montecarlo.cpp)."""
    sx, sy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    ax, ay = sx.abs(), sy.abs()
    use_x = ax > ay
    r = torch.where(use_x, ax, ay)
    safe_sx = torch.where(sx == 0, torch.ones_like(sx), sx)
    safe_sy = torch.where(sy == 0, torch.ones_like(sy), sy)
    theta = torch.where(use_x, (math.pi / 4) * (sy / safe_sx),
                        math.pi / 2 - (math.pi / 4) * (sx / safe_sy))
    theta = theta + torch.where(torch.where(use_x, sx < 0, sy < 0),
                                torch.full_like(theta, math.pi), torch.zeros_like(theta))
    r = torch.where((sx == 0) & (sy == 0), torch.zeros_like(r), r)
    return r * torch.cos(theta), r * torch.sin(theta)


@dataclass
class MatteMeshScene:
    """Triangles [T, 3, 3] with a material index each, matte colours
    [M, 3], one point light, a perspective camera's field of view."""

    tris: np.ndarray
    tri_mat: np.ndarray
    kd_rgb: np.ndarray
    light_from: np.ndarray
    light_rgb: np.ndarray
    fov: float
    maxdepth: int


class Triangles:
    """The scene's triangles in blocks of BLOCK, each with a box padded by
    a thousandth of the scene's extent, on `device` in `dtype`."""

    def __init__(self, tris: np.ndarray, dtype, device):
        tris = np.asarray(tris, np.float64)
        T = len(tris)
        # blocks of triangles near each other: sorted along a Morton curve
        # of their centroids, big triangles alone in blocks of their own
        cen = tris.mean(1)
        lo, hi = cen.min(0), cen.max(0)
        q = np.clip(((cen - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.int64), 0, 1023)
        code = np.zeros(T, np.int64)
        for bit in range(10):
            for ax in range(3):
                code |= ((q[:, ax] >> bit) & 1) << (3 * bit + ax)
        ext = np.linalg.norm(tris.max(1) - tris.min(1), axis=1)
        big = ext > 0.05 * np.linalg.norm(tris.reshape(-1, 3).max(0) - tris.reshape(-1, 3).min(0))
        order = np.concatenate([np.nonzero(big)[0],
                                np.nonzero(~big)[0][np.argsort(code[~big], kind="stable")]])
        groups = [order[i:i + 1] for i in range(int(big.sum()))]
        small = order[int(big.sum()):]
        groups += [small[i:i + BLOCK] for i in range(0, len(small), BLOCK)]
        B = len(groups)
        idx = np.full((B, BLOCK), -1, np.int64)
        for b, g in enumerate(groups):
            idx[b, :len(g)] = g
        v = tris[np.clip(idx, 0, None)]                       # [B, BLOCK, 3, 3]
        v = np.where((idx >= 0)[..., None, None], v, 0.0)     # padding: degenerate
        pad = 1e-3 * np.linalg.norm(tris.reshape(-1, 3).max(0) - tris.reshape(-1, 3).min(0))
        real = (idx >= 0)[..., None, None]
        box_lo = np.where(real, v, np.inf).min((1, 2)) - pad
        box_hi = np.where(real, v, -np.inf).max((1, 2)) + pad

        def dev(x, dt=dtype):
            return torch.as_tensor(x, device=device).to(dt)

        self.idx = dev(idx, torch.int64)
        self.v0 = dev(v[:, :, 0])
        self.e1 = dev(v[:, :, 1] - v[:, :, 0])
        self.e2 = dev(v[:, :, 2] - v[:, :, 0])
        self.box_lo, self.box_hi = dev(box_lo), dev(box_hi)

    def closest(self, o, d, tmax):
        """-> (t, prim) of the closest hit in (0, tmax) of each ray; prim -1
        where there is none."""
        R = o.shape[0]
        dev = o.device
        t_best = torch.full((R,), float("inf"), dtype=torch.float64, device=dev)
        prim = torch.full((R,), -1, dtype=torch.int64, device=dev)
        live = torch.nonzero(tmax > 0)[:, 0]
        if live.numel() == 0:
            return t_best.to(o.dtype), prim
        # (ray, block) pairs whose box the ray's segment enters
        inv = 1.0 / torch.where(d[live] == 0, torch.full_like(d[live], 1e-30), d[live])
        ol = o[live]
        t0 = (self.box_lo[None] - ol[:, None]) * inv[:, None]
        t1 = (self.box_hi[None] - ol[:, None]) * inv[:, None]
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        enter = (near <= far) & (far >= 0) & (near <= tmax[live][:, None])
        ray_i, blk = torch.nonzero(enter, as_tuple=True)
        ray_i = live[ray_i]
        ts, ps = [], []
        for s in range(0, ray_i.numel(), PAIR_CHUNK):
            r, b = ray_i[s:s + PAIR_CHUNK], blk[s:s + PAIR_CHUNK]
            t, ok = self._mt(o[r][:, None], d[r][:, None], tmax[r][:, None],
                             self.v0[b], self.e1[b], self.e2[b])
            t = torch.where(ok, t.to(torch.float64), torch.full((), float("inf"),
                                                                dtype=torch.float64, device=dev))
            t_min = t.amin(1)
            ids = self.idx[b]
            ts.append(t_min)
            ps.append(torch.where(t == t_min[:, None], ids, torch.full_like(ids, 1 << 62))
                      .amin(1))
        if not ts:
            return t_best.to(o.dtype), prim
        t_pair, p_pair = torch.cat(ts), torch.cat(ps)
        t_best.scatter_reduce_(0, ray_i, t_pair, "amin")
        # among a ray's pairs that reach its least t, the lowest index
        win = (t_pair == t_best[ray_i]) & torch.isfinite(t_pair)
        none = 1 << 62
        keep = torch.full((R,), none, dtype=torch.int64, device=dev)
        keep.scatter_reduce_(0, ray_i, torch.where(win, p_pair, torch.full_like(p_pair, none)),
                             "amin")
        prim = torch.where(keep < none, keep, prim)
        return t_best.to(o.dtype), prim

    @staticmethod
    def _mt(o, d, tmax, v0, e1, e2):
        """Moller-Trumbore (pbrt-v2 shapes/trianglemesh.cpp Triangle::Intersect)."""
        s1 = cross(d.expand_as(e2), e2)
        det = dot(s1, e1)
        inv = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
        s = o - v0
        b1 = dot(s, s1) * inv
        s2 = cross(s, e1)
        b2 = dot(d.expand_as(s2), s2) * inv
        t = dot(e2, s2) * inv
        ok = (det != 0) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 0) & (t < tmax)
        return t, ok


class Reference:
    """Renders pixels of frames of a MatteMeshScene. A frame is (seed, eye,
    look, up); a pixel is (frame index, x, y)."""

    def __init__(self, scene: MatteMeshScene, xres: int, yres: int, spp: int,
                 dtype=torch.float32, device="cpu"):
        self.s, self.xres, self.yres, self.spp = scene, xres, yres, spp
        self.dtype, self.device = dtype, torch.device(device)
        self.tris = Triangles(scene.tris, dtype, self.device)
        v = np.asarray(scene.tris, np.float64)
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        ng = np.cross(e1, e2)
        self.tri_ng = self._dev(ng / np.maximum(np.linalg.norm(ng, axis=1, keepdims=True), 1e-30))
        self.tri_ss = self._dev(e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-30))
        self.tri_mat = torch.as_tensor(np.asarray(scene.tri_mat, np.int64), device=self.device)
        self.kd = self._dev(np.stack([rgb_to_spectrum(c) for c in scene.kd_rgb]))
        white = rgb_to_spectrum((1.0, 1.0, 1.0))
        self.light_I = self._dev(rgb_to_spectrum(scene.light_rgb) * white)
        self.light_p = self._dev(scene.light_from)
        self.s2xyz = self._dev(S2XYZ.T)
        self.y = self._dev(S2XYZ[1])

    def _dev(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device).to(self.dtype)

    def camera_rays(self, frames, fi, px, py):
        """World rays through the continuous raster points (px, py) of the
        frames fi (pbrt-v2 PerspectiveCamera::GenerateRay)."""
        aspect = self.xres / self.yres
        x0, x1, y0, y1 = ((-aspect, aspect, -1.0, 1.0) if aspect > 1
                          else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))
        tan_half = math.tan(math.radians(self.s.fov) / 2)
        sx = (x0 + px.to(torch.float64) / self.xres * (x1 - x0)) * tan_half
        sy = (y1 - py.to(torch.float64) / self.yres * (y1 - y0)) * tan_half
        d_cam = torch.stack([sx, sy, torch.ones_like(sx)], -1)
        rot = torch.as_tensor(np.stack([look_at(f[1], f[2], f[3]) for f in frames]),
                              device=self.device)
        eye = torch.as_tensor(np.stack([np.asarray(f[1], np.float64) for f in frames]),
                              device=self.device)
        d = torch.einsum("nij,nj->ni", rot[fi], d_cam)
        return eye[fi].to(self.dtype), unit(d).to(self.dtype)

    def render(self, frames, fi, x, y):
        """-> linear RGB [N, 3] (float64 NumPy) of pixels (x, y) of frames fi."""
        dev, dt = self.device, self.dtype
        fi = torch.as_tensor(np.asarray(fi, np.int64), device=dev)
        x = torch.as_tensor(np.asarray(x, np.int64), device=dev)
        y = torch.as_tensor(np.asarray(y, np.int64), device=dev)
        seeds = torch.as_tensor(np.asarray([int(f[0]) for f in frames], np.int64), device=dev)
        seed = seeds[fi]
        pid = y * self.xres + x
        xyz = torch.zeros((x.shape[0], 3), dtype=torch.float64, device=dev)
        for s in range(self.spp):
            sidx = torch.full_like(pid, s)
            ox, oy = self._offsets(pid, sidx, seed)
            o, d = self.camera_rays(frames, fi, x.to(dt) + ox, y.to(dt) + oy)
            L = self.trace(o, d, pid, sidx, seed)
            xyz += (L @ self.s2xyz).to(torch.float64)
        rgb = (xyz / self.spp) @ torch.as_tensor(XYZ_TO_RGB.T, device=dev)
        return rgb.clamp(min=0.0).cpu().numpy()

    def _offsets(self, pid, sidx, seed):
        # each frame's seed enters the hash as a Python int in the renderer:
        # the same arithmetic on the int64 tensor
        return pixel_offsets(pid, sidx, seed, self.dtype)

    def u(self, pid, sidx, seed, depth, dim):
        return bounce_uniform(pid, sidx, seed, depth, dim, self.dtype)

    def trace(self, o, d, pid, sidx, seed):
        """Path radiance [N, 30] of camera rays (o, d)."""
        N = o.shape[0]
        dev, dt = self.device, self.dtype
        tp = torch.ones((N, N_BINS), dtype=dt, device=dev)
        L = torch.zeros((N, N_BINS), dtype=dt, device=dev)
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        tmax = torch.full((N,), BIG, dtype=dt, device=dev)
        for depth in range(self.s.maxdepth):
            t, prim = self.tris.closest(o, d, torch.where(alive, tmax, -torch.ones_like(tmax)))
            alive = alive & (prim >= 0)
            pr = prim.clamp(min=0)
            p = o + t[:, None] * d
            ng, ss = self.tri_ng[pr], self.tri_ss[pr]
            ts = cross(ng, ss)
            kd = self.kd[self.tri_mat[pr]]
            wo = -unit(d)
            wo_n = dot(wo, ng)

            def f_of(wi):
                reflect = dot(wi, ng) * wo_n > 0
                return torch.where(reflect[:, None], kd / math.pi, torch.zeros_like(kd))

            # direct lighting from the point light
            to_l = self.light_p[None] - p
            dist2 = dot(to_l, to_l).clamp(min=1e-12)
            dist = torch.sqrt(dist2)
            wi_l = to_l / dist[:, None]
            f_l = f_of(wi_l)
            cos_l = dot(wi_l, ng).abs()
            use = alive & (cos_l > 0) & (f_l.amax(1) > 0)
            blocked = self.tris.closest(p + wi_l * RAY_EPS, wi_l,
                                        torch.where(use, dist * (1 - 1e-3),
                                                    -torch.ones_like(dist)))[1] >= 0
            use = use & ~blocked
            Ld = f_l * self.light_I[None] / dist2[:, None] * cos_l[:, None]
            L = L + torch.where(use[:, None], tp * Ld, torch.zeros_like(Ld))
            if depth == self.s.maxdepth - 1:
                break
            # the next direction: cosine-weighted about ng, on wo's side
            lx, ly = concentric_disk(self.u(pid, sidx, seed, depth, 5),
                                     self.u(pid, sidx, seed, depth, 6))
            lz = torch.sqrt((1 - lx * lx - ly * ly).clamp(min=0))
            lz = torch.where(wo_n < 0, -lz, lz)
            wi = lx[:, None] * ss + ly[:, None] * ts + lz[:, None] * ng
            pdf = lz.abs() / math.pi
            f = f_of(wi)
            tp_new = tp * f * (dot(wi, ng).abs() / pdf.clamp(min=1e-12))[:, None]
            alive = alive & (pdf > 1e-12) & (tp_new.amax(1) > 0)
            if depth >= RR_START:
                q = ((tp_new @ self.y) / (tp @ self.y).clamp(min=1e-9)).clamp(0.05, 1.0)
                alive = alive & (self.u(pid, sidx, seed, depth, 8) < q)
                tp_new = tp_new / q[:, None]
            tp = torch.where(alive[:, None], tp_new, torch.zeros_like(tp_new))
            o, d = p + wi * RAY_EPS, wi
        return L
