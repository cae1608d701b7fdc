"""Plain reference for the photon shoot of the CS348B dispersion scene
(`disp`): the caustic, indirect and direct photons that the renderer
stores each frame, in plain PyTorch, path for path.

It imports nothing of the renderer it checks. The benchmark hands it the
scene as numbers (perfbench/reference/disp.py DispScene), and it traces
its own photon paths from them, as the renderer states the algorithm
(photon/shooter.py build_photon_maps and Shooter, after pbrt-v2's
photonshooter.cpp with the CS348B dispersion):

- the paths: batches of 4,096 (the renderer's batch while the quotas
  total at most 300,000), path `lane` of batch `b` drawing uniform
  (depth, dim) from the integrator's counter-based stream keyed by
  (lane, b x 4,096, the frame's seed): perfbench/reference/pathtrace.py
  bounce_uniform;
- the emission: the one point light, picked with probability 1; the
  direction uniform on the sphere (z = 1 - 2 u1, phi = 2 pi u2; dims 1
  and 2), normalised; the power I x 4 pi. The scene's medium holds no
  volume photons (volumephotons 0), so the shoot does not track it;
- each of 5 depths: the closest shape (perfbench/reference/disp.py, the
  quadrics in object space). At the matte disk a photon is stored: a
  direct one where it is the path's first surface, a caustic one where
  every surface before it was the glass, an indirect one otherwise; a
  record counts where its power sums above 0. Then the path bounces off
  the disk (the cosine hemisphere of dims 32 and 33 in the disk's
  shading frame, flipped to wo's side; f = Kd / pi and pdf = |cos| / pi
  where wi and wo lie on one side of the normal) or through the glass
  (Kr 0: the transmission lobe, picked where dim 31 is above 0). At the
  path's first glass surface one wavelength bin is drawn (dim 30) in
  proportion to the power's bins, the power keeps that bin alone
  divided by its probability, and the path carries the bin's wavelength
  400 + 300 i / 29 nm; the glass refracts with the Cauchy index of that
  wavelength (pbrt-v2 CS348B reflection.cpp: B =
  0.52345 (eta - 1) / Vn, A = eta - B / 0.34522792, eta(lambda) = A + B /
  lambda_um^2); total internal reflection ends the path. The new power is
  power x f x |cos| / pdf, and the path survives Russian roulette with
  probability max(0.1, y(new) / y(old)) capped at 1 (dim 35), its power
  divided by it; the next ray leaves p + 1e-3 wi;
- the quotas: batches run until the caustic and the indirect photons
  stored reach the configuration's quotas, or to the cap of max(64,
  ceil(6 x the quotas / 4,096)) batches (the give-up rule needs 500,000
  shots, past that cap); a map keeps its first quota of records in
  (batch, lane, depth) order (the direct map max(10,000, the quotas)),
  each power divided by the paths shot when its quota was met, else by
  all the paths shot.

Departures from the renderer's arithmetic: the sums the check reads are
taken in float64. The radiance-photon candidates (dim 37) change no map
here (no final gather) and are not drawn. Everything else runs in
`dtype`: float32 for the reference, bfloat16 for the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .disp import (
    BIG,
    DISK,
    INV_PI,
    N_BINS,
    RAY_EPS,
    SPHERE,
    DispScene,
    SceneTensors,
    normalize,
)
from .pathtrace import bounce_uniform, concentric_disk, dot

BATCH = 4096
CAUSTIC, INDIRECT, DIRECT = 1, 2, 3
LAMBDA_START, LAMBDA_END = 400.0, 700.0


@dataclass
class Shoot:
    """What a frame's shoot stored: batches and paths shot, the records of
    each class counted, the caustic map's total power (float64) and mean
    position, and the caustic and indirect maps (positions, powers over
    the paths shot, directions; None where a map holds nothing). The
    scene stores no volume photons: `volume` is 0, as
    perfbench/control_photons.py reads it."""

    batches: int
    shots: int
    caustic: int
    indirect: int
    direct: int
    caustic_power: float
    caustic_mean_pos: np.ndarray
    caustic_map: Optional[tuple] = None
    indirect_map: Optional[tuple] = None
    volume: int = 0


def max_batches(quota: int) -> int:
    return max(64, int(np.ceil(quota * 6 / BATCH)))


def cauchy_eta(eta, vn, lam_nm):
    b = 0.52345 * (eta - 1.0) / vn.clamp(min=1e-6)
    a = eta - b / 0.34522792
    lam_um = lam_nm * 1e-3
    return a + b / (lam_um * lam_um).clamp(min=1e-12)


class Shooter(SceneTensors):
    """The shoot of a DispScene at its quotas; a frame is its seed.
    `chunk` batches are traced at once."""

    def __init__(self, scene: DispScene, dtype=torch.float32, device="cpu", chunk: int = 16):
        super().__init__(scene, dtype, device)
        self.chunk = int(chunk)
        self.quotas = {CAUSTIC: int(scene.caustic_photons), INDIRECT: int(scene.indirect_photons)}
        self.quotas[DIRECT] = max(self.quotas[CAUSTIC], self.quotas[INDIRECT], 10000)
        self.power0 = self.light_I * (4.0 * math.pi)
        self.lambdas = self._dev(LAMBDA_START + np.arange(N_BINS) * (LAMBDA_END - LAMBDA_START)
                                 / (N_BINS - 1))

    def _y(self, s):
        return s @ self.y

    def _paths(self, first_batch: int, n_batches: int, seed: int):
        """Traces the paths of batches [first, first + n) -> per path and
        depth: the record's class (0 none), position, power and
        direction."""
        dt, dev = self.dtype, self.device
        L = n_batches * BATCH
        g = torch.arange(L, dtype=torch.int64, device=dev)
        lane = g % BATCH
        shot_base = (first_batch + g // BATCH) * BATCH
        seeds = torch.full((L,), int(seed), dtype=torch.int64, device=dev)

        def u(depth, dim):
            return bounce_uniform(lane, shot_base, seeds, depth, dim, dt)

        zero = torch.zeros((), dtype=dt, device=dev)
        z1 = 1.0 - 2.0 * u(0, 1)
        r = torch.sqrt((1.0 - z1 * z1).clamp(min=0.0))
        phi = 2.0 * math.pi * u(0, 2)
        ray_d = normalize(torch.stack([r * torch.cos(phi), r * torch.sin(phi), z1], -1))
        ray_o = self.light_pos.expand(L, 3)
        alpha = self.power0.expand(L, -1)
        alive = (alpha > 0).any(-1)
        specular_only = torch.ones(L, dtype=torch.bool, device=dev)
        n_inter = torch.zeros(L, dtype=torch.int64, device=dev)
        lam = torch.full((L,), -1.0, dtype=dt, device=dev)
        cls, pos, power, wis = [], [], [], []
        for depth in range(self.s.photon_depth):
            big = torch.full((L,), BIG, dtype=dt, device=dev)
            h = self.surface(ray_o, ray_d, self.closest(ray_o, ray_d,
                                                        torch.where(alive, big, -big)))
            surf = alive & (h.prim >= 0)
            matte = surf & (h.prim == DISK)
            n_s = n_inter + surf.to(torch.int64)
            c = torch.where(n_s == 1, DIRECT, torch.where(specular_only, CAUSTIC, INDIRECT))
            counted = matte & (alpha.sum(-1) > 0)
            cls.append(torch.where(counted, c, 0))
            pos.append(h.p)
            power.append(torch.where(matte[:, None], alpha, zero))
            wis.append(-ray_d)
            if depth == self.s.photon_depth - 1:
                break
            # the first glass surface draws the path's wavelength bin
            glass = surf & (h.prim == SPHERE)
            pick = glass & (lam < 0)
            p_bin = alpha / alpha.sum(-1, keepdim=True).clamp(min=1e-20)
            b = (u(depth, 30)[:, None] > p_bin.cumsum(-1)).sum(-1).clamp(max=N_BINS - 1)
            p_b = p_bin.gather(1, b[:, None])[:, 0]
            w_b = torch.where(alpha.sum(-1) > 0, 1.0 / p_b.clamp(min=1e-20), zero)
            one_hot = (torch.arange(N_BINS, device=dev) == b[:, None]).to(dt)
            alpha = torch.where(pick[:, None], alpha * one_hot * w_b[:, None], alpha)
            lam = torch.where(pick, self.lambdas[b], lam)
            wo = -normalize(ray_d)
            # the matte bounce
            x, y = concentric_disk(u(depth, 32), u(depth, 33))
            wz = torch.sqrt((1.0 - x * x - y * y).clamp(min=0.0))
            wz = torch.where(dot(wo, h.n) < 0, -wz, wz)
            wi_m = h.world(torch.stack([x, y, wz], -1))
            same = dot(wi_m, h.n) * dot(wo, h.n) > 0
            f_m = torch.where(same[:, None], self.kd * INV_PI, zero)
            pdf_m = torch.where(same, dot(wi_m, h.n).abs() * INV_PI, zero)
            ok_m = pdf_m > 1e-12
            # the glass, at the wavelength's index
            eta = torch.where((self.vn > 0) & (lam > 0), cauchy_eta(self.eta, self.vn, lam),
                              self.eta.expand(L))
            wi_g, f_g, ok_g = self.refract(h, wo, eta)
            ok_g = ok_g & (u(depth, 31) > 0.0)
            wi = torch.where(glass[:, None], wi_g, wi_m)
            f = torch.where(glass[:, None], f_g, f_m)
            pdf = torch.where(glass, torch.ones_like(pdf_m), pdf_m)
            ok = torch.where(glass, ok_g, ok_m)
            a_new = alpha * f * (dot(wi, h.n).abs() / pdf.clamp(min=1e-12))[:, None]
            cont = (self._y(a_new) / self._y(alpha).clamp(min=1e-12)).clamp(0.0, 1.0)
            cont = torch.where(cont > 0, cont.clamp(min=0.1), zero)
            survive = u(depth, 35) < cont
            a_new = a_new / cont.clamp(min=1e-9)[:, None]
            go = surf & ok & survive & (a_new > 0).any(-1)
            alpha = torch.where(go[:, None], a_new, alpha)
            ray_o = torch.where(go[:, None], h.p + wi * RAY_EPS, ray_o)
            ray_d = torch.where(go[:, None], wi, ray_d)
            specular_only = specular_only & ~matte
            n_inter = n_s
            alive = go
        return (torch.stack(cls, 1), torch.stack(pos, 1), torch.stack(power, 1),
                torch.stack(wis, 1))

    def shoot(self, seed: int, batches: int = None) -> Shoot:
        """The frame's shoot. `batches` cuts it short (a control that
        shoots fewer paths than the renderer's rule)."""
        q = self.quotas
        cap = max_batches(q[CAUSTIC] + q[INDIRECT]) if batches is None else int(batches)
        counts = dict.fromkeys((CAUSTIC, INDIRECT, DIRECT), 0)
        kept = {c: [] for c in (CAUSTIC, INDIRECT)}
        n_kept = dict.fromkeys((CAUSTIC, INDIRECT), 0)
        full = {}                      # the paths shot when each quota was met
        done = 0
        finished = False
        while done < cap and not finished:
            nb = min(self.chunk, cap - done)
            cls, pos, power, wi = self._paths(done, nb, int(seed))
            for k in range(nb):
                rows = slice(k * BATCH, (k + 1) * BATCH)
                c = cls[rows].reshape(-1)
                for cl in counts:
                    counts[cl] += int((c == cl).sum())
                for cl in kept:
                    take = torch.nonzero(c == cl).squeeze(1)[:max(q[cl] - n_kept[cl], 0)]
                    if take.numel():
                        kept[cl].append(tuple(a[rows].reshape(-1, a.shape[-1])[take]
                                              for a in (pos, power, wi)))
                        n_kept[cl] += take.numel()
                done += 1
                for cl in (CAUSTIC, INDIRECT, DIRECT):
                    if cl not in full and counts[cl] >= q[cl]:
                        full[cl] = done * BATCH
                if counts[CAUSTIC] >= q[CAUSTIC] and counts[INDIRECT] >= q[INDIRECT]:
                    finished = True
                    break
        shots = done * BATCH

        def photon_map(cl):
            if not kept[cl]:
                return None
            p, a, w = (torch.cat([part[i] for part in kept[cl]]) for i in range(3))
            return p, a / full.get(cl, shots), w

        caustic = photon_map(CAUSTIC)
        power, mean = 0.0, np.full(3, np.nan)
        if caustic is not None:
            power = float(caustic[1].to(torch.float64).sum())
            mean = caustic[0].to(torch.float64).mean(0).cpu().numpy()
        return Shoot(batches=done, shots=shots, caustic=counts[CAUSTIC],
                     indirect=counts[INDIRECT], direct=counts[DIRECT], caustic_power=power,
                     caustic_mean_pos=mean, caustic_map=caustic,
                     indirect_map=photon_map(INDIRECT))
