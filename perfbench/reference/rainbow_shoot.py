"""Plain reference for the photon shoot of the CS348B rainbow scene
(`rainbowc`): the volume and direct photons that the renderer stores each
frame, in plain PyTorch, path for path.

It imports nothing of the renderer it checks. The benchmark hands it the
scene as numbers (perfbench/reference/rainbow.py RainbowScene), and it
traces its own photon paths from them, as the renderer states the
algorithm (photon/shooter.py build_photon_maps and shoot_batch_fn,
after pbrt-v2's photonshooter.cpp with the CS348B volume photons):

- the paths: batches of 4,096 (the renderer's batch while the quotas
  total at most 300,000), path `lane` of batch `b` drawing uniform
  (depth, dim) from the integrator's counter-based stream keyed by
  (lane, b x 4,096, the frame's seed): perfbench/reference/pathtrace.py
  bounce_uniform, which is the renderer's integrator_uniform;
- the emission: the one distant light, picked with probability 1; the
  origin on a disk of the triangles' bounding sphere (its centre and
  radius as the renderer computes them) facing the light, by the
  concentric map of dims 1 and 2; the direction away from the light;
  the power L x pi r^2;
- each of 5 depths: the closest of the 6 triangles (Moller-Trumbore, as
  the eye pass's reference); Woodcock tracking over the box's span
  before that hit, 4 trials of -log(u) / majorant (dims 10 + 2k and 11 +
  2k), the majorant the y-weighted sigma_t, so a trial inside the box is
  an interaction; at an interaction a volume photon is stored unless it
  is the path's first, and the path scatters (dims 18-20: the
  renderer's inverted albedo test `u > albedo`, a uniform direction,
  the isotropic phase, the scene's g being 0) or ends; a path that
  reaches a wall untouched stores a direct photon at its first
  interaction (an indirect one after that), then bounces off the matte
  wall (the cosine hemisphere of dims 32 and 33 in the shading frame the
  renderer builds from the wall's uv parameterisation, f = Kd / pi) and
  survives Russian roulette with probability max(0.1, y(new) / y(old))
  (dim 35);
- the quotas: batches run until the volume photons stored reach the
  configuration's `volumephotons`, or to the cap of max(64, ceil(6 x
  quota / 4,096)) batches (the give-up rule needs 500,000 shots, past
  that cap); a record counts where its power sums above 0; the volume
  map keeps the first `volumephotons` records in (batch, lane, depth)
  order, each power divided by the paths shot.

Departures from the renderer's arithmetic: the frames' tangents and the
distant light's direction are computed once per triangle and once per
scene in float64, then cast (the renderer computes them per hit in
float32); f x cos / pdf of the matte bounce is formed from the same
terms in another order; the sums the check reads are taken in float64.
The radiance-photon candidates (dim 37) and the dispersion draw (dim
30) change neither count nor map here and are not drawn. Everything
else runs in `dtype`: float32 for the reference, bfloat16 for the
control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .pathtrace import bounce_uniform, concentric_disk, cross, dot, unit
from .rainbow import BIG, RAY_EPS, RainbowScene, SceneTensors

BATCH = 4096
DEPTH = 5                 # maxphotondepth's default
INV_PI = 1.0 / math.pi
INV_FOURPI = 1.0 / (4.0 * math.pi)


@dataclass
class Shoot:
    """What a frame's shoot stored: batches and paths shot, the records of
    each class counted, and the volume map's total power (float64) and
    mean position."""

    batches: int
    shots: int
    volume: int
    direct: int
    indirect: int
    volume_power: float
    volume_mean_pos: np.ndarray


def max_batches(quota: int) -> int:
    return max(64, int(np.ceil(quota * 6 / BATCH)))


def coordinate_system(v):
    """The renderer's CoordinateSystem (core/geometry.py): (v2, v3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    use_x = x.abs() > y.abs()
    inv_a = 1.0 / torch.sqrt(torch.where(use_x, x * x + z * z, y * y + z * z).clamp(min=1e-24))
    zero = torch.zeros_like(x)
    v2 = torch.where(use_x[..., None], torch.stack([-z * inv_a, zero, x * inv_a], -1),
                     torch.stack([zero, z * inv_a, -y * inv_a], -1))
    return v2, cross(v, v2)


def shading_frames(scene: RainbowScene) -> np.ndarray:
    """[T, 3, 3] (ss, ts, ns) of each triangle, float64: ns the geometric
    normal (the walls have no normals), ss dp/du of the triangle's uv
    parameterisation made orthogonal to ns, ts = ns x ss."""
    tris = np.asarray(scene.tris, np.float64)
    uv = np.asarray(scene.tri_uv, np.float64)
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    ns = np.cross(e1, e2)
    ns /= np.linalg.norm(ns, axis=-1, keepdims=True)
    du1, du2 = uv[:, 1] - uv[:, 0], uv[:, 2] - uv[:, 0]
    det = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    if np.any(np.abs(det) < 1e-12):
        raise ValueError("a degenerate uv parameterisation: this reference takes none")
    dpdu = (du2[:, 1, None] * e1 - du1[:, 1, None] * e2) / det[:, None]
    ss = dpdu / np.linalg.norm(dpdu, axis=-1, keepdims=True)
    ss = ss - ns * np.sum(ss * ns, -1, keepdims=True)
    ss /= np.linalg.norm(ss, axis=-1, keepdims=True)
    return np.stack([ss, np.cross(ns, ss), ns], 1)


class Shooter(SceneTensors):
    """The shoot of a RainbowScene, `quota` volume photons wanted; a frame
    is its seed. `chunk` batches are traced at once."""

    def __init__(self, scene: RainbowScene, quota: int, dtype=torch.float32, device="cpu",
                 chunk: int = 16):
        super().__init__(scene, dtype, device)
        self.quota, self.chunk = int(quota), int(chunk)
        self.frames = self._dev(shading_frames(scene))
        # the triangles' bounding sphere, as the renderer bounds them:
        # float32 corners, 1e-3 of slack
        tris = np.asarray(scene.tris, np.float64).astype(np.float32)
        lo = tris.reshape(-1, 3).min(0) - np.float32(1e-3)
        hi = tris.reshape(-1, 3).max(0) + np.float32(1e-3)
        self.world_c = self._dev(0.5 * (lo + hi))
        self.world_rad = float(np.linalg.norm(hi - lo) * 0.5) + 1e-3
        self.power0 = self.light_L * (math.pi * self.world_rad * self.world_rad)
        # the y-weighted sigma_t as a majorant, and the normalisation that
        # maps a flat sigma to itself
        y_np = np.asarray(self.y.to(torch.float64).cpu())
        y_ones = float(y_np.sum())
        sig_t = np.asarray((self.sigma_a + self.sigma_s).to(torch.float64).cpu())
        self.majorant = max(float(sig_t @ y_np) / max(y_ones, 1e-12), 1e-6)
        self.y_norm = 1.0 / max(y_ones, 1e-12)

    def _y(self, s):
        return s @ self.y

    def _paths(self, first_batch: int, n_batches: int, seed: int):
        """Traces the paths of batches [first, first + n) -> per path and
        depth: volume record stored, its position and power sum; direct
        and indirect records stored."""
        dt, dev = self.dtype, self.device
        L = n_batches * BATCH
        g = torch.arange(L, dtype=torch.int64, device=dev)
        lane = g % BATCH
        shot_base = (first_batch + g // BATCH) * BATCH
        seeds = torch.full((L,), int(seed), dtype=torch.int64, device=dev)

        def u(depth, dim):
            return bounce_uniform(lane, shot_base, seeds, depth, dim, dt)

        zero = torch.zeros((), dtype=dt, device=dev)
        big = torch.full((L,), BIG, dtype=dt, device=dev)
        # emission from a disk facing the distant light
        wl = unit(self.light_wi)[None].expand(L, 3)
        v1, v2 = coordinate_system(wl)
        dx, dy = concentric_disk(u(0, 1), u(0, 2))
        ray_o = self.world_c + self.world_rad * (dx[:, None] * v1 + dy[:, None] * v2 + wl)
        ray_d = unit(-wl)
        alpha = self.power0.expand(L, -1)
        alive = ~(alpha <= 0).all(-1)
        n_inter = torch.zeros((L,), dtype=torch.int64, device=dev)
        sig_t = self.sigma_a + self.sigma_s
        sig_box = self._y(sig_t) * self.y_norm
        albedo_box = self._y(self.sigma_s) / self._y(sig_t).clamp(min=1e-12)
        vol_rec, vol_pos, vol_pow, direct, indirect = [], [], [], [], []

        for depth in range(DEPTH):
            t, prim = self.closest(ray_o, ray_d, torch.where(alive, big, -torch.ones_like(big)))
            valid = prim >= 0
            # Woodcock tracking over the box before the surface
            vhit, vt0, vt1 = self.box_span(ray_o, ray_d, torch.where(valid, t, big))
            t_try, t_int = vt0, big
            interacted = torch.zeros((L,), dtype=torch.bool, device=dev)
            for k in range(4):
                t_try = t_try - torch.log(u(depth, 10 + 2 * k).clamp(min=1e-12)) / self.majorant
                inside = vhit & (t_try < vt1) & ~interacted & alive
                in_box = self.inside(ray_o + t_try[:, None] * ray_d)
                sig_here = torch.where(in_box, sig_box, zero)
                accept = inside & (u(depth, 11 + 2 * k) * self.majorant < sig_here)
                t_int = torch.where(accept & ~interacted, t_try, t_int)
                interacted = interacted | accept
            p_int = ray_o + t_int[:, None] * ray_d
            albedo = torch.where(self.inside(p_int), albedo_box, zero)
            store_vol = interacted & (n_inter >= 1)
            vol_rec.append(store_vol & (alpha.sum(-1) > 0))
            vol_pos.append(p_int)
            vol_pow.append(alpha.to(torch.float64).sum(-1))
            scatter = interacted & (u(depth, 18) > albedo)
            z = 1.0 - 2.0 * u(depth, 19)
            r = torch.sqrt((1.0 - z * z).clamp(min=0.0))
            phi = 2.0 * math.pi * u(depth, 20)
            new_d = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
            w_scale = torch.full((L,), INV_FOURPI, dtype=dt, device=dev) * 4.0 * math.pi
            alpha = torch.where(scatter[:, None], alpha * w_scale[:, None], alpha)
            ray_o = torch.where(scatter[:, None], p_int, ray_o)
            ray_d_new = torch.where(scatter[:, None], new_d, ray_d)
            n_inter = n_inter + interacted.to(torch.int64)
            alive = alive & ~(interacted & ~scatter)
            surface = alive & valid & ~interacted
            # the wall: a direct photon at the path's first interaction
            n_inter_s = n_inter + surface.to(torch.int64)
            counted = surface & (alpha.sum(-1) > 0)
            direct.append(counted & (n_inter_s == 1))
            indirect.append(counted & (n_inter_s != 1))
            if depth == DEPTH - 1:
                break
            # the matte bounce in the triangle's shading frame
            fr = self.frames[prim.clamp(min=0)]
            ss, ts, ns = fr[:, 0], fr[:, 1], fr[:, 2]
            hit_p = ray_o + t[:, None] * ray_d
            wo = -unit(ray_d_new)
            wo_z = dot(wo, ns)
            x, y = concentric_disk(u(depth, 32), u(depth, 33))
            wz = torch.sqrt((1.0 - x * x - y * y).clamp(min=0.0))
            wz = torch.where(wo_z < 0, -wz, wz)
            wi = x[:, None] * ss + y[:, None] * ts + wz[:, None] * ns
            reflect = dot(wi, ns) * dot(wo, ns) > 0
            pdf = torch.where(reflect, dot(wi, ns).abs() * INV_PI, zero)
            f = torch.where(reflect[:, None], self.kd * INV_PI, zero)
            a_new = alpha * f * (dot(wi, ns).abs() / pdf.clamp(min=1e-12))[:, None]
            cont = (self._y(a_new) / self._y(alpha).clamp(min=1e-12)).clamp(0.0, 1.0)
            cont = torch.where(cont > 0, cont.clamp(min=0.1), zero)
            survive = u(depth, 35) < cont
            a_new = a_new / cont.clamp(min=1e-9)[:, None]
            bounce = surface & (pdf > 1e-12) & survive & ~(a_new <= 0).all(-1)
            alpha = torch.where(bounce[:, None], a_new, alpha)
            ray_o = torch.where(bounce[:, None], hit_p + wi * RAY_EPS, ray_o)
            ray_d = torch.where(bounce[:, None], wi, ray_d_new)
            n_inter = n_inter_s
            alive = (interacted & alive) | bounce
        return (torch.stack(vol_rec, 1), torch.stack(vol_pos, 1).to(torch.float64),
                torch.stack(vol_pow, 1), torch.stack(direct, 1), torch.stack(indirect, 1))

    def shoot(self, seed: int, batches: int = None) -> Shoot:
        """The frame's shoot. `batches` cuts it short (a control that
        shoots fewer paths than the renderer's rule)."""
        cap = max_batches(self.quota) if batches is None else int(batches)
        limit = max(self.quota, 1)
        done = 0
        n_vol = n_dir = n_ind = 0
        power = 0.0
        pos = torch.zeros(3, dtype=torch.float64, device=self.device)
        kept = 0
        while done < cap and n_vol < self.quota:
            nb = min(self.chunk, cap - done)
            rec, p, pw, dr, ind = self._paths(done, nb, int(seed))
            per_batch = rec.reshape(nb, -1).sum(1).tolist()
            take = nb
            for k, c in enumerate(per_batch):        # stop at the batch that fills the quota
                n_vol += c
                if n_vol >= self.quota:
                    take = k + 1
                    break
            rows = take * BATCH
            rec, p, pw = rec[:rows].reshape(-1), p[:rows].reshape(-1, 3), pw[:rows].reshape(-1)
            n_dir += int(dr[:rows].sum())
            n_ind += int(ind[:rows].sum())
            # the volume map keeps the first `limit` records in order
            idx = torch.nonzero(rec).reshape(-1)[:max(limit - kept, 0)]
            kept += idx.shape[0]
            power += float(pw[idx].sum())
            pos = pos + p[idx].sum(0)
            done += take
        shots = done * BATCH
        return Shoot(batches=done, shots=shots, volume=n_vol, direct=n_dir, indirect=n_ind,
                     volume_power=power / shots,
                     volume_mean_pos=(pos / max(kept, 1)).cpu().numpy())
