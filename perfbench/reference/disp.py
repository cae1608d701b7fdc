"""Plain reference for the CS348B dispersion scene (`disp`): the eye pass of
`photonmap` with its live caustic and indirect lookups, and the medium's
transmittance, in plain PyTorch, for chosen pixels of chosen frames.

It imports nothing of the renderer it checks and takes nothing the
renderer made: the benchmark hands it the scene as numbers (DispScene)
and each frame's caustic and indirect photon maps, which the plain
shooter (perfbench/reference/disp_shoot.py) traces from the same
numbers, and it builds its own spectra, rays, hits, density estimates
and pixel sums from them. It follows each camera sample path for path,
as the renderer states the algorithm for this scene (pbrt-v2's
SamplerRenderer::Li = Tr * Li_surface + Li_volume, with photonmap.cpp's
PhotonIntegrator and emission.cpp's EmissionIntegrator, the volume
integrator the scene file leaves to its default):

- the samples: the lowdiscrepancy pixel offsets and the integrator's
  counter-based streams of perfbench/reference/pathtrace.py;
- the camera: pbrt-v2's perspective RasterToCamera applied to the
  raster point as an affine map, the direction normalised in camera
  space, then CameraToWorld (the scene's LookAt);
- the shapes: the glass sphere and the matte disk, pbrt-v2's quadrics,
  each tested in its own object space (the ray taken there by the
  inverse of its transform): the sphere by the quadratic A t^2 + B t + C
  with pbrt's stable roots (q = -0.5 (B + sign(B) sqrt(disc)), t0 = q /
  A, t1 = C / q), the nearer root first, a root kept where 0 < t < tmax
  and the hit's z lies in [-r, r]; the disk (z = 0, no inner radius) by
  t = -o_z / d_z where |d_z| > 1e-12 and x^2 + y^2 <= r^2. Both are whole
  (phimax 360). The nearer shape wins, the sphere on a tie. At the hit:
  the point o + t d in object space taken back to the world, the normal
  (the point itself on the sphere, +z on the disk) by the inverse
  transpose, normalised; dpdu = phimax (-y, x, 0); the shading frame ss
  = dpdu made orthogonal to n, ts = n x ss;
- the surface (photonmap, maxdepth 5): at the matte disk, the point
  light's contribution f I / d^2 |cos| (f = Kd / pi where wi and wo lie
  on one side of the normal: a quadric's geometric normal is its
  shading normal) unless the
  shadow ray from p + 1e-3 wi to within (1 - 1e-3) of the light hits a
  shape, times the medium's transmittance toward the light; then the
  caustic and the indirect density estimates (below), each times Kd /
  pi, and the path ends. At the glass (Kr 0, Kt the white reflectance):
  no estimate, and the path goes on by specular transmission, the
  transmission lobe picked where the lobe draw (dim 4) is above 0:
  Snell's law in the frame with the sphere's index 1.5168 (a camera
  path carries no wavelength, so the eye side disperses nothing; the
  shoot does), total internal reflection ending the path, the weight (1
  - Fr) (ei / et)^2, Fr pbrt's dielectric Fresnel; the next ray leaves
  p + 1e-3 wi along the unnormalised refracted direction;
- the density estimates (photonmap.cpp LPhoton with the packages'
  capped-grid kNN): the photons of a map lie on a uniform grid, and a
  query's candidates are, in each of the 27 cells around its own (in
  the z, y, x order of the offsets), the first `cap` photons of that
  cell in map order, cap = max(24, ceil(4 k / 27)); each candidate within
  maxdist^2 is weighted by max(1, its cell's photons / cap); the k
  nearest candidates are kept, ties to the earlier candidate (27-cell
  order, then map order); r^2 is the kth distance where k are found,
  else maxdist^2; each kept photon adds its power times Simpson's kernel
  3 / pi (1 - d^2 / r^2)^2 / r^2 to the front half (its direction on the
  side of the normal faced toward wo) or the back half, and the estimate
  is front x rho_r / pi + back x rho_t / pi (rho_r = Kd, rho_t = 0 on the
  disk). The grid: the photons' box grown by 1e-4, a cell the larger of
  the map's cell size (maxdist for the caustic map, 2 maxdist for the
  indirect one) and (2 k V / (27 P))^(1/3), the dimensions
  ceil(extent / cell) halved until they hold at most 2^24 cells, a
  photon's cell from its float32 position in float64, a query's in
  float32, clamped to the grid. `CappedGrid` finds each query's
  candidates by testing every photon of the map (brute force), not by
  the packages' sorted cells;
- the volume: the emission march of n steps over the medium box's span
  before the surface (n = the box diagonal / stepsize, in [4, 128]),
  step i at t0 + (i + u) dt, u the stream's (depth 0, dim 40), summing
  sigma_t dt where the point lies in the box; the camera sample's
  radiance is exp(-that sum) x L_surface where the ray crossed the box
  (the medium emits nothing); the shadow rays' transmittance is the
  closed form exp(-sigma_t x the box's chord), so the renderer's jitter
  of that march (its position hash) is drawn by neither;
- the film: the box filter of half-width 0.5, so a sample lands in its
  own pixel: a pixel is the mean of its samples' XYZ, to linear RGB by
  pbrt-v2's matrix, clamped at 0.

Departures from the renderer's arithmetic: the sums of a density
estimate run over the photons in another order; the film's sums are in
float64 (the renderer's are float32 sums). The grid's bookkeeping runs
on the host in NumPy. Everything else runs in `dtype`: float32 for the
reference, bfloat16 for the control.
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
)
from .rainbow import affine, linear, raster_to_camera
from .rainbow_shoot import coordinate_system

N_BINS = 30
BIG = 1e30
RAY_EPS = 1e-3
INV_PI = 1.0 / math.pi
CHUNK = 1 << 14          # camera samples traced at once
PAIRS = 1 << 22          # (query, photon) pairs a lookup holds at once
SPHERE, DISK = 0, 1      # the shapes, in the scene's order
MAX_STEPS = 128
GRID_PAD = 1e-4
MAX_CELLS = 1 << 24


@dataclass
class DispScene:
    """The scene as numbers: the point light (world position, RGB I), the
    glass sphere (object-to-world [4, 4], radius, Kr and Kt RGB, index,
    Abbe number), the matte disk (object-to-world, radius, Kd RGB), the
    medium box (world corners, RGB sigma_a and sigma_s), the camera
    (camera-to-world [4, 4], fov), the photon map's settings and the
    depths."""

    light_pos: np.ndarray
    light_rgb: np.ndarray
    sphere_o2w: np.ndarray
    sphere_radius: float
    glass_kr_rgb: np.ndarray
    glass_kt_rgb: np.ndarray
    eta: float
    vn: float
    disk_o2w: np.ndarray
    disk_radius: float
    kd_rgb: np.ndarray
    box_lo: np.ndarray
    box_hi: np.ndarray
    sigma_a_rgb: np.ndarray
    sigma_s_rgb: np.ndarray
    cam_to_world: np.ndarray
    fov: float
    n_used: int
    max_dist: float
    caustic_photons: int
    indirect_photons: int
    max_depth: int = 5          # photonmap's maxdepth
    photon_depth: int = 5       # maxphotondepth
    stepsize: float = 1.0       # the emission march's


def n_steps(scene: DispScene) -> int:
    diag = float(np.linalg.norm(np.asarray(scene.box_hi) - np.asarray(scene.box_lo)))
    return int(np.clip(int(np.ceil(diag / max(scene.stepsize, 1e-6))), 4, MAX_STEPS))


def normalize(v):
    """v / |v|; zero where |v|^2 <= 1e-20."""
    n2 = dot(v, v)[..., None]
    inv = 1.0 / torch.sqrt(n2.clamp(min=1e-20))
    return v * torch.where(n2 > 1e-20, inv, torch.zeros_like(inv))


def rsqrt_normalize(x, y, z):
    inv = torch.rsqrt((x * x + y * y + z * z).clamp(min=1e-24))
    return torch.stack([x * inv, y * inv, z * inv], -1)


@dataclass
class Hits:
    """The closest shape of each ray: t (BIG where none), prim (SPHERE,
    DISK, -1), the world point, the normal and the shading frame."""

    t: torch.Tensor
    prim: torch.Tensor
    p: torch.Tensor = None
    n: torch.Tensor = None
    ss: torch.Tensor = None
    ts: torch.Tensor = None

    def local(self, v):
        """World vectors [N, 3] in the hit's frame (ss, ts, n)."""
        return torch.stack([dot(v, self.ss), dot(v, self.ts), dot(v, self.n)], -1)

    def world(self, v):
        return v[..., 0:1] * self.ss + v[..., 1:2] * self.ts + v[..., 2:3] * self.n


class SceneTensors:
    """A DispScene's numbers as tensors of `dtype`, and the geometry both
    references trace: the closest shape, its differential geometry, the
    medium box's span, and the glass's refraction."""

    def __init__(self, scene: DispScene, dtype=torch.float32, device="cpu"):
        self.s = scene
        self.dtype, self.device = dtype, torch.device(device)
        o2w = [np.asarray(scene.sphere_o2w, np.float64), np.asarray(scene.disk_o2w, np.float64)]
        self.o2w = [self._dev(m) for m in o2w]
        self.w2o = [self._dev(np.linalg.inv(m)) for m in o2w]
        self.radius = [self._dev(scene.sphere_radius), self._dev(scene.disk_radius)]
        self.phimax = self._dev(2.0 * math.pi)
        white = self._dev(rgb_to_spectrum((1.0, 1.0, 1.0)))
        self.light_I = self._dev(rgb_to_spectrum(scene.light_rgb)) * white
        self.light_pos = self._dev(scene.light_pos)
        self.kd = self._dev(rgb_to_spectrum(scene.kd_rgb))
        self.kt = self._dev(rgb_to_spectrum(scene.glass_kt_rgb))
        self.eta, self.vn = self._dev(scene.eta), self._dev(scene.vn)
        self.lo, self.hi = self._dev(scene.box_lo), self._dev(scene.box_hi)
        self.sigma_a = self._dev(rgb_to_spectrum(scene.sigma_a_rgb))
        self.sigma_s = self._dev(rgb_to_spectrum(scene.sigma_s_rgb))
        self.y = self._dev(S2XYZ[1])
        if np.any(rgb_to_spectrum(scene.glass_kr_rgb) > 0):
            raise ValueError("this reference takes a glass with Kr 0 alone")

    def _dev(self, x):
        return torch.as_tensor(np.asarray(x, np.float64), device=self.device).to(self.dtype)

    # -- the shapes -----------------------------------------------------

    def _object(self, q, o, d):
        return affine(self.w2o[q], o), linear(self.w2o[q], d)

    def _sphere_t(self, o, d, tmax):
        (ox, oy, oz), (dx, dy, dz) = o.unbind(-1), d.unbind(-1)
        r = self.radius[SPHERE]
        a = dx * dx + dy * dy + dz * dz
        b = 2.0 * (ox * dx + oy * dy + oz * dz)
        c = ox * ox + oy * oy + oz * oz - r * r
        disc = b * b - 4.0 * a * c
        sq = torch.sqrt(disc.clamp(min=0.0))
        q = -0.5 * (b + torch.where(b >= 0.0, sq, -sq))
        one = torch.ones((), dtype=o.dtype, device=o.device)
        ta = q / torch.where(a.abs() > 1e-12, a, one)
        tb = c / torch.where(q.abs() > 1e-12, q, one)
        t0, t1 = torch.minimum(ta, tb), torch.maximum(ta, tb)

        def ok(t):
            z = oz + t * dz
            return (disc >= 0.0) & (z >= -r) & (z <= r) & (t > 0.0) & (t < tmax)

        ok0, ok1 = ok(t0), ok(t1)
        big = torch.full_like(t0, BIG)
        return torch.where(ok0, t0, torch.where(ok1, t1, big)), ok0 | ok1

    def _disk_t(self, o, d, tmax):
        oz, dz = o[..., 2], d[..., 2]
        r = self.radius[DISK]
        one = torch.ones((), dtype=o.dtype, device=o.device)
        t = (0.0 - oz) / torch.where(dz.abs() > 1e-12, dz, one)
        x, y = o[..., 0] + t * d[..., 0], o[..., 1] + t * d[..., 1]
        ok = (dz.abs() > 1e-12) & (x * x + y * y <= r * r) & (t > 0.0) & (t < tmax)
        return torch.where(ok, t, torch.full_like(t, BIG)), ok

    def closest(self, o, d, tmax) -> Hits:
        """The closest shape along o + t d in (0, tmax); t BIG and prim -1
        where there is none (tmax < 0: the ray is dead)."""
        ts, ok_s = self._sphere_t(*self._object(SPHERE, o, d), tmax)
        td, ok_d = self._disk_t(*self._object(DISK, o, d), tmax)
        disk = ok_d & (~ok_s | (td < ts))
        prim = torch.where(disk, DISK, torch.where(ok_s, SPHERE, -1))
        t = torch.where(disk, td, torch.where(ok_s, ts, torch.full_like(ts, BIG)))
        return Hits(t, prim)

    def occluded(self, o, d, tmax):
        return self.closest(o, d, tmax).prim >= 0

    def surface(self, o, d, h: Hits) -> Hits:
        """h with the world point, the normal and the frame of its hits."""
        ps, ns, dps = [], [], []
        for q in (SPHERE, DISK):
            oq, dq = self._object(q, o, d)
            pq = oq + h.t[:, None] * dq
            x, y, z = pq.unbind(-1)
            if q == SPHERE:
                nx, ny, nz = x, y, z
            else:
                nx, ny, nz = torch.zeros_like(x), torch.zeros_like(x), torch.ones_like(x)
            m = self.w2o[q]          # the normal by the inverse transpose
            ns.append(rsqrt_normalize(m[0, 0] * nx + m[1, 0] * ny + m[2, 0] * nz,
                                      m[0, 1] * nx + m[1, 1] * ny + m[2, 1] * nz,
                                      m[0, 2] * nx + m[1, 2] * ny + m[2, 2] * nz))
            ps.append(affine(self.o2w[q], pq))
            dps.append(linear(self.o2w[q], torch.stack([-self.phimax * y, self.phimax * x,
                                                         torch.zeros_like(x)], -1)))
        disk = (h.prim == DISK)[:, None]
        p = torch.where(disk, ps[1], ps[0])
        n = torch.where(disk, ns[1], ns[0])
        ss = normalize(torch.where(disk, dps[1], dps[0]))
        ss = normalize(ss - n * dot(ss, n)[:, None])
        ss = torch.where((dot(ss, ss) < 0.5)[:, None], coordinate_system(n)[0], ss)
        return Hits(h.t, h.prim, p, n, ss, cross(n, ss))

    # -- the medium -----------------------------------------------------

    def box_span(self, o, w, t_hi):
        """The medium box's span [t0, t1] along o + t w within [0, t_hi]
        -> (hit, t0, t1), t0 = t1 = 0 where the ray misses it."""
        inv = 1.0 / w
        ta, tb = (self.lo - o) * inv, (self.hi - o) * inv
        t0 = torch.maximum(torch.minimum(ta, tb).amax(-1), torch.zeros_like(t_hi))
        t1 = torch.minimum(torch.maximum(ta, tb).amin(-1), t_hi)
        hit = t0 <= t1
        zero = torch.zeros((), dtype=o.dtype, device=o.device)
        return hit, torch.where(hit, t0, zero), torch.where(hit, t1, zero)

    def light_transmittance(self, p, wi, dist):
        """exp(-sigma_t x the box's chord) between p and p + dist wi."""
        hit, t0, t1 = self.box_span(p, normalize(wi), dist)
        tau = (t1 - t0).clamp(min=0.0)[:, None] * (self.sigma_a + self.sigma_s)
        return torch.where(hit[:, None], torch.exp(-tau), torch.ones_like(tau))

    def inside(self, p):
        return ((p >= self.lo) & (p <= self.hi)).all(-1)

    # -- the glass ------------------------------------------------------

    def refract(self, h: Hits, wo, eta):
        """Specular transmission through the glass at h for the unit
        direction wo toward the viewer, index `eta` [N] -> (the world
        direction, its weight (1 - Fr) (ei / et)^2 / |cos t| x Kt [N, S],
        no total internal reflection)."""
        wl = h.local(wo)
        cos_o = wl[:, 2]
        one = torch.ones_like(cos_o)
        entering = cos_o > 0.0
        ei = torch.where(entering, one, eta)
        et = torch.where(entering, eta, one)
        ratio = ei / et
        sint2 = ratio * ratio * (1.0 - cos_o * cos_o).clamp(min=0.0)
        tir = sint2 >= 1.0
        cost = torch.sqrt((1.0 - sint2).clamp(min=0.0))
        cost = torch.where(entering, -cost, cost)
        wi = h.world(torch.stack([ratio * -wl[:, 0], ratio * -wl[:, 1], cost], -1))
        fr = fresnel_dielectric(cos_o, eta)
        f = self.kt * ((1.0 - fr) * (ei * ei) / (et * et) / cost.abs().clamp(min=1e-7))[:, None]
        return wi, torch.where(tir[:, None], torch.zeros_like(f), f), ~tir


def fresnel_dielectric(cos_i, eta):
    """pbrt-v2's FrDiel between vacuum and index eta; cos_i > 0 enters."""
    one = torch.ones_like(cos_i)
    entering = cos_i > 0.0
    ei = torch.where(entering, one, eta)
    et = torch.where(entering, eta, one)
    ci = cos_i.abs()
    sint = ei / et * torch.sqrt((1.0 - ci * ci).clamp(min=0.0))
    cost = torch.sqrt((1.0 - sint * sint).clamp(min=0.0))
    r_par = (et * ci - ei * cost) / (et * ci + ei * cost).clamp(min=1e-12)
    r_per = (ei * ci - et * cost) / (ei * ci + et * cost).clamp(min=1e-12)
    return torch.where(sint >= 1.0, one, 0.5 * (r_par * r_par + r_per * r_per))


# ---------------------------------------------------------------------------
# The capped-grid kNN (module docstring)

def default_cap(k: int) -> int:
    return max(24, -(-4 * k // 27))


class CappedGrid:
    """A photon map (positions [P, 3], powers [P, S], directions [P, 3], in
    map order) under the capped-grid lookup of k photons within
    max_dist2."""

    def __init__(self, pos, alpha, wi, cell_size: float, k: int, max_dist2: float, dtype,
                 device):
        self.k, self.max_dist2, self.cap = int(k), float(max_dist2), default_cap(k)
        dev = torch.device(device)
        pos_np = pos.detach().to(torch.float32).cpu().numpy()
        P = len(pos_np)
        lo = pos_np.min(0) - GRID_PAD
        hi = pos_np.max(0) + GRID_PAD
        cell = max(float(cell_size), 1e-6)
        if k > 0:
            volume = float(np.prod(np.maximum(hi - lo, 1e-6)))
            cell = max(cell, (2.0 * k * volume / (27.0 * max(P, 1))) ** (1.0 / 3.0))
        dims = np.maximum(1, np.ceil((hi - lo) / cell)).astype(np.int64)
        while int(np.prod(dims)) > MAX_CELLS:
            dims = np.maximum(1, dims // 2)
        inv_cell = dims / np.maximum(hi - lo, 1e-12)
        cells = np.clip(((pos_np - lo) * inv_cell).astype(np.int64), 0, dims - 1)
        # each photon's rank among the photons of its cell, in map order,
        # and its cell's count
        key = (cells[:, 2] * dims[1] + cells[:, 1]) * dims[0] + cells[:, 0]
        order = np.argsort(key, kind="stable")
        ks = key[order]
        first = np.searchsorted(ks, ks, side="left")
        rank = np.empty(P, np.int64)
        rank[order] = np.arange(P) - first
        count = np.empty(P, np.int64)
        count[order] = np.searchsorted(ks, ks, side="right") - first
        self.dims = torch.as_tensor(dims, device=dev)
        self.lo = torch.as_tensor(lo, device=dev)
        self.inv_cell = torch.as_tensor(inv_cell.astype(np.float32), device=dev)
        self.cells = torch.as_tensor(cells, device=dev)
        self.rank = torch.as_tensor(rank, device=dev)
        self.weight = torch.as_tensor(np.maximum(count.astype(np.float32)
                                                 / np.float32(self.cap), 1.0), device=dev)
        self.pos = pos.to(dev, torch.float32)
        self.alpha, self.wi = alpha.to(dev, dtype), wi.to(dev, dtype)

    def query_cells(self, q):
        c = torch.nan_to_num((q.to(torch.float32) - self.lo) * self.inv_cell)
        return torch.minimum(torch.floor(c).clamp(min=0).long(), self.dims - 1)

    def nearest(self, q):
        """-> (photon ids [Q, k'] nearest first, valid [Q, k'], squared
        distances [Q, k'], r^2 [Q]) of each query, k' = min(k, P)."""
        Q, P = q.shape[0], self.pos.shape[0]
        kk = min(self.k, P)
        ids, valid, d2s, r2s = [], [], [], []
        qc = self.query_cells(q)
        qf = q.to(torch.float32)
        step = max(1, PAIRS // max(P, 1))
        none = torch.iinfo(torch.int64).max
        for s in range(0, Q, step):
            dc = self.cells[None] - qc[s:s + step, None]                      # [B, P, 3]
            near = (dc.abs() <= 1).all(-1) & (self.rank < self.cap)[None]
            slot = (((dc[..., 2] + 1) * 3 + dc[..., 1] + 1) * 3 + dc[..., 0] + 1) * self.cap
            slot = slot + self.rank[None]
            qb = qf[s:s + step]
            d2 = ((self.pos[None, :, 0] - qb[:, None, 0]) ** 2
                  + (self.pos[None, :, 1] - qb[:, None, 1]) ** 2
                  + (self.pos[None, :, 2] - qb[:, None, 2]) ** 2)
            ok = near & (d2 <= self.max_dist2)
            key = (d2.view(torch.int32).to(torch.int64) << 32) | slot
            key = torch.where(ok, key, torch.full_like(key, none))
            top_key, top = torch.topk(key, kk, dim=1, largest=False, sorted=True)
            v = top_key < none
            d2k = torch.where(v, torch.gather(d2, 1, top), torch.zeros_like(top_key,
                                                                              dtype=d2.dtype))
            found = v.sum(1)
            kth = d2k.amax(1)
            r2 = torch.where(found >= min(self.k, 27 * self.cap), kth,
                             torch.full_like(kth, self.max_dist2)).clamp(min=1e-12)
            ids.append(top)
            valid.append(v)
            d2s.append(d2k)
            r2s.append(r2)
        return torch.cat(ids), torch.cat(valid), torch.cat(d2s), torch.cat(r2s)

    def surface_estimate(self, q, n, wo, rho_r, rho_t):
        """LPhoton at points q [Q, 3] with normals n and directions wo
        toward the viewer [Q, S]."""
        dt = self.alpha.dtype
        if q.shape[0] == 0 or self.pos.shape[0] == 0:
            return torch.zeros((q.shape[0], N_BINS), dtype=dt, device=q.device)
        ids, valid, d2, r2 = self.nearest(q)
        r2, d2 = r2.to(dt), d2.to(dt)
        s = (1.0 - d2 / r2[:, None].clamp(min=1e-12)).clamp(min=0.0)
        kern = 3.0 * INV_PI * s * s / r2[:, None].clamp(min=1e-12)
        kern = torch.where(valid, kern * self.weight[ids].to(dt), torch.zeros_like(kern))
        sgn = torch.where(dot(wo, n) >= 0.0, 1.0, -1.0).to(dt)
        w = self.wi[ids]
        front = ((w[..., 0] * n[:, 0:1] + w[..., 1] * n[:, 1:2] + w[..., 2] * n[:, 2:3])
                 * sgn[:, None]) > 0.0
        A = self.alpha[ids]                                               # [Q, k', S]
        zero = torch.zeros((), dtype=dt, device=q.device)
        flux_f = (A * torch.where(front, kern, zero)[..., None]).sum(1)
        flux_b = (A * torch.where(front, zero, kern)[..., None]).sum(1)
        return (flux_f * rho_r + flux_b * rho_t) * INV_PI


# ---------------------------------------------------------------------------
# The eye pass

class Reference(SceneTensors):
    """Renders pixels of frames of a DispScene at a film of xres x yres and
    spp samples a pixel. A frame is its seed and its photon maps; a pixel
    is (frame index, x, y)."""

    def __init__(self, scene: DispScene, xres: int, yres: int, spp: int,
                 dtype=torch.float32, device="cpu"):
        super().__init__(scene, dtype, device)
        self.xres, self.yres, self.spp = xres, yres, spp
        self.r2c = self._dev(raster_to_camera(xres, yres, scene.fov))
        self.c2w = self._dev(scene.cam_to_world)
        self.s2xyz = self._dev(S2XYZ.T)
        self.n_steps = n_steps(scene)

    def grids(self, caustic, indirect):
        """The frame's caustic and indirect maps ((pos, power, dir) or
        None each) as CappedGrids."""
        s = self.s
        k, d2 = s.n_used, s.max_dist * s.max_dist
        return tuple(None if m is None else CappedGrid(*m, cell, k, d2, self.dtype, self.device)
                     for m, cell in ((caustic, s.max_dist), (indirect, 2.0 * s.max_dist)))

    def radiance(self, px, py, pid, sidx, seed, grids):
        """Li [N, 30] of the camera samples at raster points (px, py)."""
        dt, dev = self.dtype, self.device
        N = px.shape[0]
        zero = torch.zeros((), dtype=dt, device=dev)

        def u(depth, dim):
            return bounce_uniform(pid, sidx, seed, depth, dim, dt)

        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        d = linear(self.c2w, normalize(affine(self.r2c, p_ras)))
        o = self.c2w[:3, 3].expand_as(d)
        cam_o, cam_d = o, d
        tp = torch.ones((N, N_BINS), dtype=dt, device=dev)
        L = torch.zeros_like(tp)
        alive = torch.ones(N, dtype=torch.bool, device=dev)
        t_cam = None
        for depth in range(self.s.max_depth + 1):
            h = self.closest(o, d, torch.where(alive, torch.full((N,), BIG, dtype=dt, device=dev),
                                               -torch.ones((N,), dtype=dt, device=dev)))
            if depth == 0:
                t_cam = h.t
            alive = alive & (h.prim >= 0)
            if depth == self.s.max_depth or not bool(alive.any()):
                break
            h = self.surface(o, d, h)
            wo = -normalize(d)
            matte = alive & (h.prim == DISK)
            L = L + torch.where(matte[:, None], self.shade(h, wo, matte, grids, u, depth) * tp,
                                zero)
            glass = alive & (h.prim == SPHERE) & (u(depth, 4) > 0.0)
            wi, f, ok = self.refract(h, wo, self.eta.expand(N))
            tp_new = tp * f * dot(wi, h.n).abs()[:, None]
            alive = glass & ok & (tp_new > 0).any(-1)
            tp = torch.where(alive[:, None], tp_new, zero)
            o, d = h.p + wi * RAY_EPS, wi
        return torch.nan_to_num(self.camera_transmittance(cam_o, cam_d, t_cam, pid, sidx, seed)
                                * L, nan=0.0, posinf=0.0, neginf=0.0)

    def shade(self, h: Hits, wo, matte, grids, u, depth):
        """The matte disk's direct light and density estimates [N, S]."""
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        to_l = self.light_pos - h.p
        dist2 = dot(to_l, to_l).clamp(min=1e-12)
        dist = torch.sqrt(dist2)
        wi = to_l / dist[:, None]
        same = dot(wi, h.n) * dot(wo, h.n) > 0
        f = torch.where(same[:, None], self.kd * INV_PI, zero)
        cos_i = dot(wi, h.n).abs()
        use = matte & (cos_i > 0) & (f > 0).any(-1)
        tmax = torch.where(use, dist * (1.0 - 1e-3), -torch.ones_like(dist))
        use = use & ~self.occluded(h.p + wi * RAY_EPS, wi, tmax)
        Ld = f * (self.light_I / dist2[:, None]) * cos_i[:, None]
        Ld = torch.where(use[:, None], Ld * self.light_transmittance(h.p, wi, dist), zero)
        ids = torch.nonzero(matte).squeeze(1)
        L = Ld
        for grid in grids:
            if grid is not None and ids.numel():
                est = grid.surface_estimate(h.p[ids], h.n[ids], wo[ids], self.kd,
                                            torch.zeros_like(self.kd))
                L = L.index_add(0, ids, est.to(L.dtype))
        return L

    def camera_transmittance(self, o, d, t_surf, pid, sidx, seed):
        """The emission march's transmittance [N, S] along the camera rays
        up to their first hit."""
        n = self.n_steps
        w = normalize(d)
        scale = torch.sqrt(dot(d, d).clamp(min=1e-20))
        hit, t0, t1 = self.box_span(o, w, t_surf * scale)
        dt = (t1 - t0).clamp(min=0.0) / n
        u0 = bounce_uniform(pid, sidx, seed, 0, 40, self.dtype)
        tau = torch.zeros((o.shape[0], N_BINS), dtype=self.dtype, device=self.device)
        for i in range(n):
            inb = self.inside(o + (t0 + (i + u0) * dt)[:, None] * w).to(self.dtype)[:, None]
            tau = tau + (inb * self.sigma_a + inb * self.sigma_s) * dt[:, None]
        return torch.where(hit[:, None], torch.exp(-tau), torch.ones_like(tau))

    def render(self, frames, fi, x, y):
        """-> linear RGB [N, 3] (float64 NumPy) of pixels (x, y) of the
        frames fi; `frames[k]` is frame k's (seed, (caustic, indirect)),
        each map (positions, powers, directions) in map order or None."""
        dev = self.device
        fi, x, y = (np.asarray(a, np.int64) for a in (fi, x, y))
        out = np.zeros((len(x), 3))
        for k, (seed, maps) in enumerate(frames):
            rows = np.nonzero(fi == k)[0]
            if not len(rows):
                continue
            grids = self.grids(*maps)
            pid = torch.as_tensor(np.repeat(y[rows] * self.xres + x[rows], self.spp), device=dev)
            sidx = torch.as_tensor(np.tile(np.arange(self.spp), len(rows)), device=dev)
            seeds = torch.full_like(pid, int(seed))
            ox, oy = pixel_offsets(pid, sidx, seeds, self.dtype)
            px = (pid % self.xres).to(self.dtype) + ox
            py = (pid // self.xres).to(self.dtype) + oy
            xyz = []
            for c in range(0, pid.shape[0], CHUNK):
                sl = slice(c, c + CHUNK)
                L = self.radiance(px[sl], py[sl], pid[sl], sidx[sl], seeds[sl], grids)
                xyz.append((L @ self.s2xyz).to(torch.float64))
            xyz = torch.cat(xyz).reshape(len(rows), self.spp, 3).mean(1).cpu().numpy()
            out[rows] = xyz @ XYZ_TO_RGB.T
        return np.maximum(out, 0.0)
