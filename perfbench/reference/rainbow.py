"""Plain reference for the CS348B rainbow scene (`rainbowc`): the eye pass
of `photonmap` + `photonvolume` over a `rainbow` volume, in plain
PyTorch, for chosen pixels of chosen frames.

It imports nothing of the renderer it checks and takes nothing the
renderer made: the benchmark hands it the scene's triangles, light,
volume box and camera transform as numbers, and it builds its own
spectra, rays, hits and film sums from them. It follows each camera
sample of a frame path for path, as the renderer states the algorithm
for this scene (pbrt-v2's SamplerRenderer::Li = Tr * Li_surface +
Li_volume, with the CS348B photonvolume integrator):

- the samples: the lowdiscrepancy pixel offsets and the integrator's
  counter-based streams of perfbench/reference/pathtrace.py (a Wang hash
  of pixel, sample index and frame seed);
- the camera: pbrt-v2's perspective RasterToCamera = Inverse(Perspective
  (fov, 1e-2, 1000)) * Inverse(ScreenToRaster) applied to the raster
  point as an affine map (its w-divide is a positive scale, which the
  normalisation of the direction removes), then CameraToWorld;
- the surface (photonmap, integrators/photonmap.py li_photonmap): the
  closest of the scene's triangles by Moller-Trumbore (a hit needs
  |det| > 1e-12 and 0 < t < 1e30; the lowest index on a tie); the walls'
  matte BSDF, Kd = the `scale` texture's product of the imagemap's one
  white texel and 0.02 grey, f = Kd / pi where wi and wo lie on one side
  of ng; the distant light picked with probability 1, its contribution f
  L |cos| unless the shadow ray from p + 1e-3 wi hits a triangle, times
  the medium's transmittance toward it. The photon estimates add
  nothing: causticphotons 0 and indirectphotons 0 leave no caustic and
  no indirect map, so `lphoton_surface` reads None and `_final_gather`
  is not reached (photonmap.py li_photonmap, the `ctx.indirect is not
  None` test), and a matte surface ends the path at depth 0;
- the volume (photonvolume, integrators/photonvolume.py li_photonvolume):
  the march of n steps over the box's span before the surface, n = the
  box diagonal / stepsize capped at 128 (integrators/volume.py
  pick_n_steps), step i at t0 + (i + u) dt with u the stream's (depth 0,
  dim 60); at each step the step's own transmittance exp(-sigma_t dt),
  the light's radiance through the medium (closed form: sigma_t times the
  box's chord toward the light), its shadow ray, and in the rainbow
  region `rainbow_reflection` of it (the CS348B angle -> wavelength
  transfer: primary bow 40.4-42.3 deg over 400-700 nm at 0.92, secondary
  51-54.4 deg reversed at 42% of that, an 8% mist, the hazy Mie phase,
  pbrt-v2's two-bin band filter); L = sigma_s Ld dt + Tr_step L; a lane
  stops once the step's y(Tr) < 1e-3. The volume photon map adds
  nothing: every march point lies in the box, which is the rainbow
  region, and photonvolume.py masks the kNN there (`want = ... &
  ~in_rainbow`), so no volume photon is read. No photon is shot here:
  the image reads none. The renderer still shoots and builds the maps
  each frame, and that time is timed: perfbench/reference/
  rainbow_shoot.py is the plain reference of that shoot, which the
  check holds the renderer's maps to;
- the result: Tr * L_surface + L_volume, with Tr the last step's
  transmittance where the camera ray crossed the box (the renderer's
  VolResult.Tr), NaN and inf to 0;
- the film: 30 bins to XYZ, pbrt-v2's gaussian filter (width 2, alpha
  2: exp(-a x^2) - exp(-a w^2) per axis) gathered by each checked pixel
  from the samples of its neighbours within the radius, XYZ -> linear
  RGB clamped at 0. The renderer pads a frame's last tile with copies
  of the frame's last pixel (renderers/driver.py render_sampler); each
  copy deposits that pixel's samples again, so they count 1 + the
  number of copies here too.

Departures from the renderer's arithmetic: the medium's transmittance
toward the light is computed once in closed form (the renderer finds the
box's span, then its chord over that span: the same numbers); the
`position_hash_u` jitter of that transmittance is drawn by neither (the
closed form of a homogeneous box takes no jitter); the filter's weights
and the film sums are in float64 (the renderer's are float32 sums in the
order of its deposits). Everything before the film runs in `dtype`:
float32 for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .pathtrace import (
    S2XYZ,
    XYZ_TO_RGB,
    bounce_uniform,
    cross,
    dot,
    pixel_offsets,
    rgb_to_spectrum,
    unit,
)

N_BINS = 30
BIG = 1e30
RAY_EPS = 1e-3
FAR = 1e7            # a ray to a distant light ends here in the medium
MAX_STEPS = 128
CHUNK = 1 << 14      # samples traced at once
LAMBDA_START, LAMBDA_END = 400.0, 700.0


@dataclass
class RainbowScene:
    """The scene as numbers: triangles [T, 3, 3] (world), their matte
    Kd as a product of RGB factors, one distant light (direction toward
    it, RGB L), one rainbow box (world-to-volume [4, 4], corners, RGB
    sigma_a and sigma_s), the camera (camera-to-world [4, 4], fov), the
    march's stepsize and the gaussian filter."""

    tris: np.ndarray
    kd_factors: tuple
    light_dir: np.ndarray
    light_rgb: np.ndarray
    w2v: np.ndarray
    box_lo: np.ndarray
    box_hi: np.ndarray
    sigma_a_rgb: np.ndarray
    sigma_s_rgb: np.ndarray
    cam_to_world: np.ndarray
    fov: float
    stepsize: float
    filter_width: float = 2.0
    filter_alpha: float = 2.0
    tri_uv: np.ndarray = None      # [T, 3, 2], the shooter's shading frames


def n_steps(scene: RainbowScene) -> int:
    """The march's step count: the box diagonal over the stepsize, in
    [4, 128]."""
    diag = float(np.linalg.norm(np.asarray(scene.box_hi) - np.asarray(scene.box_lo)))
    return int(np.clip(int(np.ceil(diag / max(scene.stepsize, 1e-6))), 4, MAX_STEPS))


def raster_to_camera(xres: int, yres: int, fov: float) -> np.ndarray:
    """pbrt-v2 ProjectiveCamera's RasterToCamera of a perspective camera."""
    aspect = xres / yres
    x0, x1, y0, y1 = ((-aspect, aspect, -1.0, 1.0) if aspect > 1
                      else (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect))

    def scale(x, y, z):
        return np.diag([x, y, z, 1.0])

    def translate(x, y, z):
        m = np.eye(4)
        m[:3, 3] = (x, y, z)
        return m

    n, f = 1e-2, 1000.0
    persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                      [0, 0, f / (f - n), -f * n / (f - n)], [0, 0, 1.0, 0]])
    inv_tan = 1.0 / math.tan(math.radians(fov) / 2.0)
    cam_to_screen = scale(inv_tan, inv_tan, 1.0) @ persp
    screen_to_raster = (scale(xres, yres, 1.0) @ scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
                        @ translate(-x0, -y1, 0.0))
    return np.linalg.inv(cam_to_screen) @ np.linalg.inv(screen_to_raster)


def affine(m, p):
    """m [4, 4] applied to points p [N, 3] without the w-divide."""
    return (m[None, :3, 0] * p[:, 0:1] + m[None, :3, 1] * p[:, 1:2]
            + m[None, :3, 2] * p[:, 2:3] + m[None, :3, 3])


def linear(m, v):
    """m's upper 3 x 3 applied to vectors v [N, 3]."""
    return m[None, :3, 0] * v[:, 0:1] + m[None, :3, 1] * v[:, 1:2] + m[None, :3, 2] * v[:, 2:3]


def band_filter(s, lam):
    """pbrt-v2's (CS348B) two-bin band filter at wavelength lam: bin i =
    floor((lam - 400) / 10) keeps s[i] t, bin i + 1 keeps s[i + 1] (1 - t),
    t the fraction past bin i's start; zero outside [400, 700)."""
    w_bin = (LAMBDA_END - LAMBDA_START) / N_BINS
    iw = (lam - LAMBDA_START) / w_bin
    i = torch.floor(iw)
    t = iw - i
    i = i.to(torch.int64).clamp(0, N_BINS - 1)
    bins = torch.arange(N_BINS, device=s.device)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    w = (torch.where(bins == i[:, None], t[:, None], zero)
         + torch.where(bins == (i + 1)[:, None], (1.0 - t)[:, None], zero))
    ok = (lam >= LAMBDA_START) & (lam < LAMBDA_END)
    return torch.where(ok[:, None], s * w, zero)


def rainbow_reflection(s, w, wi):
    """The CS348B RainbowVolume transfer (volumes/rainbow.cpp): s the
    light's spectrum at the point, w the ray's direction, wi the light's,
    theta the angle between wi and -w in degrees."""
    cos_t = dot(wi, -w).clamp(-1.0, 1.0)
    theta = torch.rad2deg(torch.arccos(cos_t))
    ramp = 1.0 - 0.1 * ((theta - 40.4) / 0.05).clamp(0.0, 1.0)
    intensity = (0.5 + 4.5 * ((1.0 + cos_t) / 2.0) ** 8) / (4.0 * math.pi) * ramp
    primary = (theta >= 40.4) & (theta <= 42.3)
    secondary = (theta >= 51.0) & (theta <= 54.4)
    lam = torch.where(primary, 400.0 + (theta - 40.4) / (42.3 - 40.4) * 300.0,
                      700.0 - (theta - 51.0) / (54.4 - 51.0) * 300.0)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    k = torch.where(primary, torch.full_like(theta, 0.92),
                    torch.where(secondary, torch.full_like(theta, 0.42 * 0.92), zero))
    return intensity[:, None] * (0.08 * s + k[:, None] * band_filter(s, lam))


class SceneTensors:
    """A RainbowScene's numbers as tensors of `dtype`, and the geometry both
    references trace: the closest triangle, the box's span, the box test
    and the closed-form transmittance toward the light."""

    def __init__(self, scene: RainbowScene, dtype=torch.float32, device="cpu"):
        self.s = scene
        self.dtype, self.device = dtype, torch.device(device)
        tris = np.asarray(scene.tris, np.float64)
        self.v0 = self._dev(tris[:, 0])
        self.e1 = self._dev(tris[:, 1] - tris[:, 0])
        self.e2 = self._dev(tris[:, 2] - tris[:, 0])
        self.ng = unit(cross(self.e1, self.e2))
        kd = np.ones(N_BINS)
        for rgb in scene.kd_factors:
            kd = kd * rgb_to_spectrum(rgb)
        self.kd = self._dev(kd)
        white = rgb_to_spectrum((1.0, 1.0, 1.0))
        self.light_L = self._dev(rgb_to_spectrum(scene.light_rgb) * white)
        ld = np.asarray(scene.light_dir, np.float64)
        self.light_wi = self._dev(ld / np.linalg.norm(ld))
        self.w2v = self._dev(scene.w2v)
        self.lo, self.hi = self._dev(scene.box_lo), self._dev(scene.box_hi)
        self.sigma_a = self._dev(rgb_to_spectrum(scene.sigma_a_rgb))
        self.sigma_s = self._dev(rgb_to_spectrum(scene.sigma_s_rgb))
        self.y = self._dev(S2XYZ[1])

    def _dev(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device).to(self.dtype)

    def closest(self, o, d, tmax):
        """(t, prim) of the closest triangle hit in (0, tmax); prim -1 and
        t BIG where none is."""
        v0, e1, e2 = self.v0[None], self.e1[None], self.e2[None]
        dd = d[:, None].expand(-1, v0.shape[1], -1)
        pv = cross(dd, e2)
        det = dot(e1, pv)
        ok_det = det.abs() > 1e-12
        inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, torch.ones_like(det)),
                          torch.zeros_like(det))
        tv = o[:, None] - v0
        b1 = dot(tv, pv) * inv
        qv = cross(tv, e1.expand_as(tv))
        b2 = dot(dd, qv) * inv
        t = dot(e2.expand_as(qv), qv) * inv
        ok = (ok_det & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > 0)
              & (t < tmax[:, None]))
        t = torch.where(ok, t, torch.full_like(t, BIG))
        t_min, prim = t.min(1)                         # the lowest index on a tie
        hit = t_min < BIG
        return torch.where(hit, t_min, torch.full_like(t_min, BIG)), torch.where(hit, prim, -1)

    def box_span(self, p, w, t_hi):
        """The rainbow box's span [t0, t1] along p + t w within [0, t_hi]
        -> (hit, t0, t1), t0 = t1 = 0 where the ray misses it."""
        o = affine(self.w2v, p)
        inv = 1.0 / linear(self.w2v, w)
        ta, tb = (self.lo - o) * inv, (self.hi - o) * inv
        t0 = torch.minimum(ta, tb).amax(-1).clamp(min=0.0)
        t1 = torch.minimum(torch.maximum(ta, tb).amin(-1), t_hi)
        hit = t0 <= t1
        zero = torch.zeros((), dtype=p.dtype, device=p.device)
        return hit, torch.where(hit, t0, zero), torch.where(hit, t1, zero)

    def inside(self, p):
        pv = affine(self.w2v, p)
        return ((pv >= self.lo) & (pv <= self.hi)).all(-1)

    def light_transmittance(self, p):
        """exp(-sigma_t x the box's chord) from p toward the light."""
        w = unit(self.light_wi.expand_as(p))
        hit, t0, t1 = self.box_span(p, w, torch.full_like(p[:, 0], FAR))
        tau = (t1 - t0).clamp(min=0.0)[:, None] * (self.sigma_a + self.sigma_s)
        return torch.where(hit[:, None], torch.exp(-tau), torch.ones_like(tau))

    def occluded(self, p, valid):
        wi = self.light_wi.expand_as(p)
        tmax = torch.where(valid, torch.full_like(p[:, 0], BIG), torch.full_like(p[:, 0], -1.0))
        return self.closest(p + wi * RAY_EPS, wi, tmax)[1] >= 0


class Reference(SceneTensors):
    """Renders pixels of frames of a RainbowScene at a film of xres x yres,
    spp samples a pixel, tiles of `tile_samples` samples, the film's
    pixels those of `window` (x0, x1, y0, y1; a crop window's, else the
    whole film). A frame is its seed; a pixel is (frame index, x, y)."""

    def __init__(self, scene: RainbowScene, xres: int, yres: int, spp: int,
                 tile_samples: int, dtype=torch.float32, device="cpu", window=None):
        super().__init__(scene, dtype, device)
        self.xres, self.yres, self.spp = xres, yres, spp
        self.window = tuple(window) if window is not None else (0, xres, 0, yres)
        self.r2c = self._dev(raster_to_camera(xres, yres, scene.fov))
        self.c2w = self._dev(scene.cam_to_world)
        self.s2xyz = self._dev(S2XYZ.T)
        self.n_steps = n_steps(scene)
        # the frame's last tile is padded with copies of its last pixel
        x0, x1, y0, y1 = self.window
        per_tile = max(1, tile_samples // spp)
        self.last_pixel = (y1 - 1) * xres + x1 - 1
        self.last_copies = 1 + (-(x1 - x0) * (y1 - y0)) % per_tile

    # -- one batch of camera samples ------------------------------------

    def radiance(self, px, py, pid, sidx, seed):
        """Li [N, 30] of the camera samples at raster points (px, py)."""
        dt_ = self.dtype
        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        d = linear(self.c2w, unit(affine(self.r2c, p_ras)))
        o = self.c2w[:3, 3].expand_as(d)
        N = d.shape[0]
        zero = torch.zeros((), dtype=dt_, device=self.device)

        # the surface: the matte walls under the distant light
        t, prim = self.closest(o, d, torch.full((N,), BIG, dtype=dt_, device=self.device))
        valid = prim >= 0
        pr = prim.clamp(min=0)
        p = o + t[:, None] * d
        ng = self.ng[pr]
        wo = -unit(d)
        wi = self.light_wi.expand_as(p)
        reflect = dot(wi, ng) * dot(wo, ng) > 0
        cos_i = dot(wi, ng).abs()
        use = valid & reflect & (cos_i > 0)
        blocked = self.occluded(p, use)
        Ls = (self.kd / math.pi) * self.light_L * cos_i[:, None] * self.light_transmittance(p)
        L_surf = torch.where((use & ~blocked)[:, None], Ls, zero)

        # the volume: the photonvolume march over the box before the surface
        n = self.n_steps
        du = unit(d)
        t_surf = torch.where(valid, t, torch.full_like(t, BIG)) * torch.sqrt(dot(d, d))
        hit, t0, t1 = self.box_span(o, du, t_surf)
        dt = (t1 - t0).clamp(min=0.0) / n
        u0 = bounce_uniform(pid, sidx, seed, 0, 60, dt_)
        L = torch.zeros((N, N_BINS), dtype=dt_, device=self.device)
        tr = torch.ones_like(L)
        active = torch.ones(N, dtype=torch.bool, device=self.device)
        sig_t = self.sigma_a + self.sigma_s
        for i in range(n):
            pi = o + (t0 + (i + u0) * dt)[:, None] * du
            inb = self.inside(pi)
            ss = torch.where(inb[:, None], self.sigma_s.expand(N, -1), zero)
            st = torch.where(inb[:, None], sig_t.expand(N, -1), zero)
            tr = torch.where(active[:, None], torch.exp(-st * dt[:, None]), tr)
            lit = hit & active
            Ld_raw = self.light_L * self.light_transmittance(pi)
            Ld = torch.where(inb[:, None], rainbow_reflection(Ld_raw, du, wi),
                             Ld_raw / (4.0 * math.pi))
            Ld = torch.where((lit & ~self.occluded(pi, lit))[:, None], Ld, zero)
            L = torch.where(active[:, None], ss * Ld * dt[:, None] + tr * L, L)
            cut = active & ((tr @ self.y) < 1e-3)
            tr = torch.where(cut[:, None], zero, tr)
            active = active & ~cut
        L_vol = torch.where(hit[:, None], L, zero)
        Tr = torch.where(hit[:, None], tr, torch.ones_like(tr))
        return torch.nan_to_num(Tr * L_surf + L_vol, nan=0.0, posinf=0.0, neginf=0.0)

    # -- pixels ---------------------------------------------------------

    def render(self, seeds, fi, x, y):
        """-> linear RGB [N, 3] (float64 NumPy) of pixels (x, y) of the
        frames fi, `seeds[k]` the seed of frame k."""
        dev = self.device
        fi, x, y = (np.asarray(a, np.int64) for a in (fi, x, y))
        W, H, spp = self.xres, self.yres, self.spp
        r = int(math.ceil(self.s.filter_width - 0.5))   # source pixels within this many
        offs = np.arange(-r, r + 1)
        # every source pixel a checked pixel gathers from, once: [K, 5, 5]
        shape = (len(x), len(offs), len(offs))
        sx = np.broadcast_to(x[:, None, None] + offs[None, None, :], shape)
        sy = np.broadcast_to(y[:, None, None] + offs[None, :, None], shape)
        sf = np.broadcast_to(fi[:, None, None], shape)
        x0, x1, y0, y1 = self.window
        inb = (sx >= x0) & (sx < x1) & (sy >= y0) & (sy < y1)
        key = (sf * H + sy) * W + sx
        src = np.unique(key[inb])
        # their samples' XYZ
        s_f, s_pid = src // (W * H), src % (W * H)
        pid = torch.as_tensor(np.repeat(s_pid, spp), device=dev)
        sidx = torch.as_tensor(np.tile(np.arange(spp), len(src)), device=dev)
        seed = torch.as_tensor(np.repeat(np.asarray(seeds, np.int64)[s_f], spp), device=dev)
        ox, oy = pixel_offsets(pid, sidx, seed, self.dtype)
        px = (pid % W).to(self.dtype) + ox
        py = (pid // W).to(self.dtype) + oy
        xyz = []
        for c in range(0, pid.shape[0], CHUNK):
            sl = slice(c, c + CHUNK)
            L = self.radiance(px[sl], py[sl], pid[sl], sidx[sl], seed[sl])
            xyz.append((L @ self.s2xyz).to(torch.float64))
        xyz = torch.cat(xyz).reshape(len(src), spp, 3).cpu().numpy()
        px = px.to(torch.float64).reshape(len(src), spp).cpu().numpy()
        py = py.to(torch.float64).reshape(len(src), spp).cpu().numpy()
        copies = np.where(s_pid == self.last_pixel, self.last_copies, 1)[:, None]
        # each checked pixel's filtered sum over its sources' samples
        j = np.where(inb, np.searchsorted(src, np.where(inb, key, src[0])), 0)
        a, wr = self.s.filter_alpha, self.s.filter_width

        def g(dist):
            v = np.exp(-a * dist * dist) - math.exp(-a * wr * wr)
            return np.where(np.abs(dist) <= wr, np.maximum(v, 0.0), 0.0)

        w = (g(x[:, None, None, None] - (px[j] - 0.5)) * g(y[:, None, None, None] - (py[j] - 0.5))
             * copies[j] * inb[..., None])                               # [K, 5, 5, spp]
        num = (w[..., None] * xyz[j]).sum((1, 2, 3))
        den = w.sum((1, 2, 3))
        rgb = np.where(den[:, None] > 0, num / np.maximum(den, 1e-300)[:, None], 0.0) @ XYZ_TO_RGB.T
        return np.maximum(rgb, 0.0)
