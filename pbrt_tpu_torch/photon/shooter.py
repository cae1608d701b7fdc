"""Wavefront photon shooting: builds the caustic, indirect, direct, volume
and radiance maps.

Port of pbrt_tpu/photon/shooter.py (reference core/photonshooter.{h,cpp}:
PhotonShootingTask :232-277 + followPhoton :47-229). A batch traces B
photon paths in lockstep to a fixed depth and emits one record per
bounce (position, power, incident direction, class); the host keeps
batches until the quotas are met, as the reference's task loop kept
4096-path blocks under a mutex (:280-355).

  * dispersion (splitSpectrum 1 -> k photons, :141-145): one wavelength
    bin is importance-sampled, keeping the lane count fixed;
  * the medium: Woodcock (null-collision) tracking against the
    y-weighted majorant, 4 trials per segment, in place of the stepped
    transmittance threshold (:61-80);
  * absorb or scatter (:88-126): the reference's test is inverted
    against textbook albedo scattering (it scatters when u > albedo.y);
    it is reproduced on purpose, for parity with the reference binary
    that rendered the goldens;
  * the abort heuristic (yield < 1/1024 past 500k shots, :285-299).

The records stay on the device. Each batch costs one host sync: the
per-class counts of its stored records (a [6] tensor), from which the
host decides the quotas and slices the class-sorted records. The maps'
host structure then needs their positions once (photon/map.py).

A batch is split at its traversals (Shooter): the emission, then per
depth the traversal and the stretch after it. Where core/graphs.py's
rule allows (on a card, without autograd), build_photon_maps replays
each stretch as a CUDA graph (ShootGraphs, captured in the scene's
first shoot); the traversals stay eager. Elsewhere, and in
shoot_batch_fn, the same stretches run eagerly, with the same values.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import info, progress, warning
from pbrt_tpu_torch.core import graphs as cuda_graphs
from pbrt_tpu_torch.core.geometry import Ray, dot, normalize
from pbrt_tpu_torch.core.sampling import uniform_sample_sphere
from pbrt_tpu_torch.lights.lighting import sample_light_ray
from pbrt_tpu_torch.materials.bsdf import (
    bsdf_sample,
    has_non_specular,
    has_transmissive,
    material_lobes,
)
from pbrt_tpu_torch.parallel import mesh as pmesh
from pbrt_tpu_torch.photon import map as pmap
from pbrt_tpu_torch.samplers.samplers import integrator_base, integrator_uniform_at
from pbrt_tpu_torch.volumes.registry import intersect_p as vol_intersect_p
from pbrt_tpu_torch.volumes.registry import phase as vol_phase
from pbrt_tpu_torch.volumes.registry import sigma_at

S = spec.N_BINS
BIG = 1e30
RAY_EPS = 1e-3
# record classes
C_NONE, C_CAUSTIC, C_INDIRECT, C_DIRECT, C_VOLUME = range(5)


@dataclass
class PhotonCtx:
    caustic: Optional[pmap.PhotonMap]
    indirect: Optional[pmap.PhotonMap]
    volume: Optional[pmap.PhotonMap]
    direct: Optional[pmap.PhotonMap]
    radiance: Optional[pmap.RadianceMap]  # precomputed-Lo map (final gather)
    n_caustic_paths: int     # paths shot to fill each map (the 1/nshot
    n_indirect_paths: int    # normalization, reference photonshooter.cpp:333)
    n_volume_paths: int
    # merged defaults (reference photonshooter.cpp:529-548)
    n_used: int
    max_dist2: float
    vol_n_used: int
    vol_max_dist2: float
    final_gather: bool
    gather_samples: int
    cos_gather_angle: float
    max_specular_depth: int
    max_photon_depth: int
    stats: dict = field(default_factory=dict)   # shooting counters (batches, syncs, ...)


def compute_majorant(scene, has_volume: bool) -> float:
    """Static Woodcock majorant: the y-weighted sigma_t summed over the
    regions, times the largest grid density."""
    vol = scene.volume
    if not (has_volume and vol is not None):
        return 1.0
    sig_spec = (vol.sigma_a + vol.sigma_s).cpu().numpy().sum(0)   # [S]
    y_ones = float(np.asarray(spec.y(np.ones((1, S), np.float32)))[0])
    sig_max = float(np.asarray(spec.y(sig_spec[None, :]))[0]) / max(y_ones, 1e-12)
    grid = vol.grid.cpu().numpy()
    gmax = float(np.max(grid)) if grid.size else 1.0
    return max(sig_max * max(gmax, 1.0), 1e-6)


REC_KEYS = ("pos", "alpha", "wi", "cls", "n", "rho_r", "rho_t", "rp")


class _Paths(NamedTuple):
    """A batch's photon paths between two traversals: the next ray
    (tmax -1 on dead lanes, which the accelerators skip), the power and
    the path's flags."""
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    tmax: torch.Tensor
    alpha: torch.Tensor
    alive: torch.Tensor
    specular_only: torch.Tensor
    n_inter: torch.Tensor
    lam_nm: torch.Tensor


def _tmax(alive):
    dev = alive.device
    return torch.where(alive, torch.full((), BIG, device=dev), torch.full((), -1.0, device=dev))


class Shooter:
    """The shooting batch of one scene, split at its traversals: the
    emission stretch (`emit`), then per depth the traversal and the
    stretch after it (`bounce`). The constants the stretches read are
    made here, once, so that CUDA graphs of the stretches (ShootGraphs)
    replay them in every later batch and frame. Each draw is
    integrator_uniform_at(base, depth, dim) of the batch's per-lane
    hash base = integrator_base(lane, shot_base, seed), the draw
    integrator_uniform(lane, shot_base, depth, dim, seed) by its
    definition."""

    def __init__(self, scene, max_depth: int, has_volume: bool,
                 sig_majorant: Optional[float] = None):
        self.scene = scene
        self.max_depth = max_depth
        self.dev = dev = scene.geom.tri_v0.device
        self.world_c = torch.as_tensor(0.5 * (scene.world_lo + scene.world_hi),
                                       dtype=torch.float32, device=dev)
        self.world_rad = float(np.linalg.norm(scene.world_hi - scene.world_lo) * 0.5) + 1e-3
        self.vol = scene.volume if has_volume else None
        if sig_majorant is None:
            sig_majorant = compute_majorant(scene, has_volume)
        self.sig_majorant = sig_majorant
        # the interaction distance is taken against the Y-weighted sigma_t, as
        # the reference compares xi with Tr.y() (photonshooter.cpp:75);
        # y_norm maps a flat sigma to itself
        self.y_norm = 1.0 / float(np.maximum(np.asarray(spec.y(np.ones((1, S), np.float32)))[0],
                                             1e-12))
        self.disp = torch.cat([scene.material_dispersive.to(torch.int32),
                               torch.zeros((1,), dtype=torch.int32, device=dev)])

    def shoot(self, base, graphs=cuda_graphs.EAGER) -> dict:
        """The batch of paths base [B] (integrator_base) -> records
        (shoot_batch_fn), the stretches through `graphs` (core/graphs.py
        EAGER, or ShootGraphs, whose static buffers then hold the base and
        each depth's hit)."""
        zf = torch.zeros(base.shape, device=self.dev)
        p = graphs.run("emit", lambda: self.emit(base))
        recs = ()
        for depth in range(self.max_depth):
            # a buffer a depth: the records keep hit.p to the last stretch
            hit = graphs.put(f"hit{depth}", self.scene.intersect(Ray(p.ray_o, p.ray_d, zf,
                                                                     p.tmax, zf)))
            p, recs = graphs.run(("bounce", depth),
                                 lambda: self.bounce(depth, p, hit, base, recs))
        return dict(zip(REC_KEYS, recs))

    def emit(self, base) -> _Paths:
        """The emission stretch: the light pick and the emitted ray."""
        B, dev = base.shape[0], self.dev

        def u(dim):
            return integrator_uniform_at(base, 0, dim)

        li, pmf = self.scene.light_dist.sample_discrete(u(0))
        lr = sample_light_ray(self.scene.lights, li, self.world_c, self.world_rad,
                              u(1), u(2), u(3), u(4))
        alpha = lr.alpha / torch.clamp(pmf, min=1e-12)[..., None]
        alive = ~spec.is_black(alpha)
        return _Paths(lr.o, lr.d, _tmax(alive), alpha, alive,
                      specular_only=torch.ones((B,), dtype=torch.bool, device=dev),
                      n_inter=torch.zeros((B,), dtype=torch.int64, device=dev),
                      lam_nm=torch.full((B,), -1.0, device=dev))

    def bounce(self, depth: int, p: _Paths, hit, base, recs: tuple):  # noqa: C901
        """The stretch after depth's traversal: Woodcock tracking and its
        volume record, the surface record, the dispersion pick, the BSDF
        continuation and roulette -> (the paths at the next traversal,
        recs with this depth's records), or at the last depth (None,
        every record stacked [B, D, ...] in REC_KEYS' order)."""
        from pbrt_tpu_torch.integrators.surface import make_frame
        from pbrt_tpu_torch.scene.compile import eval_bsdf_params

        scene, vol, dev = self.scene, self.vol, self.dev
        sig_majorant, y_norm = self.sig_majorant, self.y_norm
        B = base.shape[0]
        zero = torch.zeros((), device=dev)
        zf = torch.zeros((B,), device=dev)
        z3 = torch.zeros((B, 3), device=dev)
        zS = torch.zeros((B, S), device=dev)
        fB = torch.zeros((B,), dtype=torch.bool, device=dev)
        ray_o, ray_d, alpha, alive = p.ray_o, p.ray_d, p.alpha, p.alive
        specular_only, n_inter, lam_nm = p.specular_only, p.n_inter, p.lam_nm

        def u(dim):
            return integrator_uniform_at(base, depth, dim)

        t_hit = torch.where(hit.valid, hit.t, torch.full((), BIG, device=dev))
        if vol is not None:
            # Woodcock tracking before the surface: up to 4 trials
            vhit, vt0, vt1 = vol_intersect_p(vol, ray_o, ray_d, zf, t_hit)
            t_try = vt0
            interacted = torch.zeros((B,), dtype=torch.bool, device=dev)
            t_int = torch.full((B,), BIG, device=dev)
            for wtrial in range(4):
                step = -torch.log(torch.clamp(u(10 + 2 * wtrial), min=1e-12)) / sig_majorant
                t_try = t_try + step
                inside = vhit & (t_try < vt1) & ~interacted & alive
                sa_t, ss_t, _, _ = sigma_at(vol, ray_o + t_try[..., None] * ray_d)
                sig_here = spec.y(sa_t + ss_t) * y_norm
                accept = inside & (u(11 + 2 * wtrial) * sig_majorant < sig_here)
                t_int = torch.where(accept & ~interacted, t_try, t_int)
                interacted = interacted | accept
            p_int = ray_o + t_int[..., None] * ray_d
            sa_i, ss_i, _, g_i = sigma_at(vol, p_int)
            albedo = spec.y(ss_i) / torch.clamp(spec.y(sa_i + ss_i), min=1e-12)
            # a volume photon is stored once the photon has interacted
            # before (the reference stores at depth > 1)
            store_vol = interacted & (n_inter >= 1)
            recs = recs + ((p_int, torch.where(store_vol[..., None], alpha, zero), -ray_d,
                            torch.where(store_vol, C_VOLUME, C_NONE), z3, zS, zS, fB),)
            # absorb or scatter: scatter iff u > albedo (the
            # reference's inverted test, photonshooter.cpp:89)
            scatter = interacted & (u(18) > albedo)
            new_d = uniform_sample_sphere(u(19), u(20))
            w_scale = (vol_phase(g_i, -ray_d, new_d) * 4.0 * math.pi)[..., None]
            alpha = torch.where(scatter[..., None], alpha * w_scale, alpha)
            ray_o = torch.where(scatter[..., None], p_int, ray_o)
            ray_d_new = torch.where(scatter[..., None], new_d, ray_d)
            n_inter = n_inter + interacted.to(torch.int64)
            specular_only = specular_only & ~interacted
            alive = alive & ~(interacted & ~scatter)
            surface_lane = alive & hit.valid & ~interacted
            ray_d = ray_d_new
        else:
            interacted = fB
            surface_lane = alive & hit.valid

        # surface interaction: store at non-specular surfaces (:148-189)
        lobes = material_lobes(eval_bsdf_params(scene, hit))
        n_inter_s = n_inter + surface_lane.to(torch.int64)
        store_surf = surface_lane & has_non_specular(lobes)
        cls = torch.where(store_surf & (n_inter_s == 1), C_DIRECT,
                          torch.where(store_surf & specular_only, C_CAUSTIC,
                                      torch.where(store_surf, C_INDIRECT, C_NONE)))
        # radiance-photon candidates: 12.5% of the deposits (:178-187),
        # the normal faceforwarded against the photon ray
        n_ff = torch.where((dot(hit.ns, -ray_d) < 0.0)[..., None], -hit.ns, hit.ns)
        recs = recs + ((hit.p, torch.where(store_surf[..., None], alpha, zero), -ray_d, cls, n_ff,
                        lobes.diff_r + lobes.gloss + lobes.spec_r, lobes.spec_t,
                        store_surf & (u(37) < 0.125)),)
        if depth == self.max_depth - 1:
            return None, tuple(torch.stack(v, 1) for v in zip(*recs))

        # dispersion (:141-145): the first transmissive dispersive
        # surface picks one wavelength bin
        disp = self.disp
        is_disp = disp[torch.clamp(hit.mat, 0, disp.shape[0] - 1)] > 0
        need_lam = surface_lane & is_disp & has_transmissive(lobes) & (lam_nm < 0)
        bin_idx, bin_w = spec.sample_bin(alpha, u(30))
        alpha = torch.where(need_lam[..., None],
                            alpha * spec.one_hot(bin_idx) * bin_w[..., None], alpha)
        lam_nm = torch.where(need_lam, spec.bin_wavelength(bin_idx), lam_nm)

        # BSDF continuation
        frame = make_frame(hit)
        bs = bsdf_sample(lobes, frame, -normalize(ray_d), u(31), u(32), u(33), u(34),
                         lam_nm=lam_nm, u_pick=u(38))
        cos_i = torch.abs(dot(bs.wi, frame.ns))
        anew = alpha * bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[..., None]
        # Russian roulette on the throughput ratio (:214-224)
        cont_p = torch.clamp(spec.y(anew) / torch.clamp(spec.y(alpha), min=1e-12), 0.0, 1.0)
        cont_p = torch.where(cont_p > 0.0, torch.clamp(cont_p, min=0.1), zero)
        survive = u(35) < cont_p
        anew = anew / torch.clamp(cont_p, min=1e-9)[..., None]
        new_alive_s = surface_lane & bs.valid & survive & ~spec.is_black(anew)
        vol_cont = interacted & alive
        alpha = torch.where(new_alive_s[..., None], anew, alpha)
        ray_o = torch.where(new_alive_s[..., None], hit.p + bs.wi * RAY_EPS, ray_o)
        ray_d = torch.where(new_alive_s[..., None], bs.wi, ray_d)
        specular_only = specular_only & torch.where(surface_lane, bs.is_specular, True)
        alive = vol_cont | new_alive_s
        return _Paths(ray_o, ray_d, _tmax(alive), alpha, alive, specular_only, n_inter_s,
                      lam_nm), recs


def shoot_batch_fn(scene, max_depth: int, has_volume: bool,
                   sig_majorant: Optional[float] = None):
    """-> batch(lane [B] int64, shot_base [B] int64, seed) -> records (the
    JAX package's _shoot_batch_fn): a dict of [B, D, ...] device tensors
    pos, alpha, wi, cls (int64; 0 none, 1 caustic, 2 indirect, 3 direct,
    4 volume), n (faceforwarded normal), rho_r, rho_t (reflectances) and
    rp (radiance-photon candidate), D records per path. The batch runs
    Shooter's stretches eagerly.

    sig_majorant: a precomputed Woodcock majorant, for a scene whose
    sigma tables require grad (diff.py re-traces the shoot with
    differentiable parameters; the majorant is a detached sampling
    control, and computing it reads the tables on the host)."""
    shooter = Shooter(scene, max_depth, has_volume, sig_majorant)

    def batch(lane, shot_base, seed: int) -> dict:
        return shooter.shoot(integrator_base(lane, shot_base, seed))

    return batch


class ShootGraphs(cuda_graphs.StretchGraphs):
    """The shooting batch's stretches of one compiled scene, lane count
    B, max photon depth D and volume flag, as CUDA graphs
    (core/graphs.py): the emission and each depth's bounce (1 + D
    graphs), sharing one memory pool. Each batch refills the static
    buffers with its integrator_base and each depth's hit; `shooter`
    keeps the constants every replay reads."""

    name = "photon"

    def __init__(self, device, shooter: Optional[Shooter] = None):
        super().__init__(device)
        self.shooter = shooter


class _Store:
    """Device-side accumulation of one map's records (the first `limit`
    in batch order) and the count of all records stored so far."""

    def __init__(self, limit: int):
        self.limit = limit
        self.parts = []
        self.kept = 0
        self.count = 0
        self.shots_full = None

    def add(self, idx, *arrays):
        take = min(idx.shape[0], self.limit - self.kept)
        if take > 0:
            self.parts.append(tuple(a[idx[:take]] for a in arrays))
            self.kept += take

    def cat(self, i):
        return torch.cat([p[i] for p in self.parts])


def _find_param(surf_params, vol_params, name, default, kind="int"):
    f = surf_params.find_one_int if kind == "int" else surf_params.find_one_float
    g = vol_params.find_one_int if kind == "int" else vol_params.find_one_float
    v = f(name, -123456789)
    return g(name, default) if v == -123456789 else v


def build_photon_maps(scene, surf_params, vol_params, options=None) -> PhotonCtx:
    """Shoot photons until the quotas are met (reference Preprocess
    :457-526 + CreatePhotonShooter :529-548 merged-parameter defaults).
    A cap of 6 x the quotas / B batches ends the shoot; a map it leaves
    short of its quota is named in a warning and in `stats["short"]`."""
    options = options or {}
    quick = bool(options.get("quick"))
    dev = scene.geom.tri_v0.device

    def find(name, default, kind="int"):
        return _find_param(surf_params, vol_params, name, default, kind)

    n_caustic = find("causticphotons", 20000)
    n_indirect = find("indirectphotons", 10000)
    n_volume = find("volumephotons", 0)
    n_used = find("nused", 50)
    max_dist = find("maxdist", 0.1, "float")
    vol_n_used = vol_params.find_one_int("nused", n_used)
    vol_max_dist = vol_params.find_one_float("maxdist", max_dist)
    final_gather = bool(surf_params.find_one_bool("finalgather", True))
    gather_samples = find("finalgathersamples", 32)
    gather_angle = find("gatherangle", 10.0, "float")
    max_spec = find("maxspeculardepth", 5)
    max_photon_depth = find("maxphotondepth", 5)
    if quick:
        n_caustic = max(1, n_caustic // 8)
        n_indirect = max(1, n_indirect // 8)
        n_volume = max(1, n_volume // 8) if n_volume else 0
        gather_samples = max(1, gather_samples // 4)
    # reference RequestSamples (photonmap.cpp:147): each of the two MIS
    # gather strategies gets gatherSamples / 2 rays
    gather_samples = max(1, gather_samples // 2)

    def ctx_of(maps, paths, stats):
        return PhotonCtx(*maps, *paths, n_used=n_used, max_dist2=max_dist * max_dist,
                         vol_n_used=vol_n_used, vol_max_dist2=vol_max_dist * vol_max_dist,
                         final_gather=final_gather, gather_samples=gather_samples,
                         cos_gather_angle=float(np.cos(np.deg2rad(gather_angle))),
                         max_specular_depth=max_spec, max_photon_depth=max_photon_depth,
                         stats=stats)

    has_volume = scene.volume is not None and n_volume > 0
    if scene.lights is None or scene.n_lights == 0:
        warning("photon shooting with no lights; maps empty")
        return ctx_of((None,) * 5, (1, 1, 1), {})

    # the batch grows with the quota (the reference's block is 4096,
    # photonshooter.cpp:247): large quotas amortize the per-batch sync
    quota_total = n_caustic + n_indirect + n_volume
    B = 4096 if quota_total <= 300_000 else 32768
    # sharded over a process group: each rank traces its slice of the
    # batch's lanes and the all-gather merges the records in rank order
    # (the photon-merge mutex, photonshooter.cpp:280-355), before the
    # count fetch, so every rank fills identical stores
    mesh = pmesh.mesh_from_options(options)
    B = pmesh.round_to_world(mesh, B)
    if mesh is not None:
        info(f"photon shooting sharded over {mesh.world} ranks")
    # direct photons have no user quota in the reference (they grow for the
    # whole shoot, for the radiance precompute); their own target keeps a
    # direct map in scenes with "indirectphotons 0"
    limit_direct = max(n_indirect, n_caustic, 10000)
    stores = {C_CAUSTIC: _Store(n_caustic), C_INDIRECT: _Store(n_indirect),
              C_VOLUME: _Store(max(n_volume, 1)), C_DIRECT: _Store(limit_direct)}
    wants = {C_CAUSTIC: n_caustic, C_INDIRECT: n_indirect, C_VOLUME: n_volume,
             C_DIRECT: limit_direct}
    rps = []
    shots = 0
    syncs = 0
    seed = int(options.get("seed", 0))
    max_batches = max(64, int(np.ceil(quota_total * 6 / B)))
    if quick:
        max_batches = min(max_batches, max(32, int(np.ceil(quota_total * 4 / B))))
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    if mesh is not None:
        lane = pmesh.shard_batch(mesh, lane)
    # on a card the stretches between the traversals replay as CUDA
    # graphs, captured in the scene's first shoot (ShootGraphs)
    graphs = cuda_graphs.graphs_for(scene, ShootGraphs, lane,
                                    (lane.shape[0], max_photon_depth, has_volume))
    shooter = graphs.keep("shooter", lambda: Shooter(scene, max_photon_depth, has_volume))
    t0 = time.time()
    batches = 0
    aborted = False
    short = {}
    for bi in range(max_batches):
        with probes.scope("photon/batch"):
            base = integrator_base(lane, torch.full(lane.shape, shots, dtype=torch.int64,
                                                    device=dev), seed)
            # a replay writes over the last batch's records: the stores
            # below keep copies (index and cat), never these tensors
            r = shooter.shoot(graphs.put("base", base), graphs)
            if mesh is not None:
                r = dict(zip(r, pmesh.gather_replicated(mesh, list(r.values()))))
            shots += B
            batches += 1
            pos, al, wi = (r["pos"].reshape(-1, 3), r["alpha"].reshape(-1, S),
                           r["wi"].reshape(-1, 3))
            code = torch.where(al.sum(-1) > 0, r["cls"].reshape(-1), C_NONE)
            rpm = r["rp"].reshape(-1) & (code != C_NONE) if final_gather else None
            counts = torch.bincount(code, minlength=5)
            if rpm is not None:
                counts = torch.cat([counts, rpm.sum()[None]])
            with probes.scope("sync/photon_batch"):
                counts = counts.tolist()   # the batch's one host sync
            syncs += 1
            order = torch.argsort(code, stable=True)
            off = np.concatenate([[0], np.cumsum(counts[:5])])
            for c, st in stores.items():
                st.add(order[off[c]:off[c + 1]], pos, al, wi)
                st.count += counts[c]
            if rpm is not None and counts[5]:
                sel = torch.argsort((~rpm).to(torch.int8), stable=True)[:counts[5]]
                rps.append((pos[sel], r["n"].reshape(-1, 3)[sel], r["rho_r"].reshape(-1, S)[sel],
                            r["rho_t"].reshape(-1, S)[sel]))
            for c, st in stores.items():
                if st.shots_full is None and st.count >= wants[c]:
                    st.shots_full = shots

            # a quota is given up only at a pathological yield (reference
            # :285-299: fewer than shots / 1024 stored after 500k shots)
            def hopeless(stored):
                return shots > 500000 and stored < shots // 1024

            nc, ni, nv = (stores[c].count for c in (C_CAUSTIC, C_INDIRECT, C_VOLUME))
            done = ((nc >= n_caustic or hopeless(nc)) and (ni >= n_indirect or hopeless(ni))
                    and (nv >= n_volume or not has_volume or hopeless(nv)))
            progress("Shooting photons", bi + 1 if not done else max_batches, max_batches, t0)
            if done:
                if hopeless(nc) or hopeless(ni) or (has_volume and hopeless(nv)):
                    aborted = True
                    warning("unable to store enough photons; aborting shooting")
                break
    else:
        # the cap ends the shoot with a quota unfilled; the reference
        # (and the JAX package) end silently here, short maps and all
        short = {name: [stores[c].count, wants[c]] for name, c in
                 (("caustic", C_CAUSTIC), ("indirect", C_INDIRECT), ("volume", C_VOLUME))
                 if stores[c].count < wants[c] and (c != C_VOLUME or has_volume)}
        warning(f"photon shooting stopped at its cap of {max_batches} batches ({shots} paths) "
                "with maps short of their quotas: " + ", ".join(
                    f"{n} {got} of {want} ({got / shots:.4f} per path)"
                    for n, (got, want) in short.items()))
    progress("Shooting photons", 1, 1, t0)
    shoot_s = time.time() - t0

    def mk(c, cell, k):
        st = stores[c]
        if st.kept == 0:
            return None
        nshot = max(st.shots_full or shots, 1)
        return pmap.build_photon_map(st.cat(0), st.cat(1) / nshot, st.cat(2), cell,
                                     target_k=k, device=dev)

    t1 = time.time()
    with probes.scope("photon/build"):
        maps = [mk(C_CAUSTIC, max_dist, n_used), mk(C_INDIRECT, max_dist * 2.0, n_used),
                mk(C_VOLUME, vol_max_dist, vol_n_used), mk(C_DIRECT, max_dist * 2.0, n_used)]
        radiance = None
        if final_gather and rps:
            radiance = compute_radiance_map(rps, maps[0], maps[1], maps[3], n_used,
                                            max_dist * max_dist, cell=max_dist * 2.0)
        maps.append(radiance)
    stats = {"batches": batches, "batch": B, "shots": shots, "syncs": syncs,
             "shoot_seconds": shoot_s, "build_seconds": time.time() - t1, "aborted": aborted,
             "short": short,
             "counts": {name: [stores[c].count, wants[c]] for name, c in
                        (("caustic", C_CAUSTIC), ("indirect", C_INDIRECT),
                         ("volume", C_VOLUME), ("direct", C_DIRECT))},
             "radiance": 0 if radiance is None else radiance.count}
    paths = tuple(stores[c].shots_full or shots for c in (C_CAUSTIC, C_INDIRECT, C_VOLUME))
    ctx = ctx_of(maps, paths, stats)
    info("photon maps: " + " ".join(
        f"{n}={0 if m is None else m.count}" for n, m in
        zip(("caustic", "indirect", "volume", "direct", "radiance"), maps))
        + f" ({shots} paths)")
    return ctx


RADIANCE_CHUNK = 1 << 18


def compute_radiance_map(rps, caustic_m, indirect_m, direct_m, n_lookup: int,
                         max_dist2: float, cell: float):
    """ComputeRadianceTask analog (reference photonshooter.cpp:359-395):
    for each radiance-photon candidate, irradiance E from the direct,
    indirect and caustic maps on both hemispheres, and Lo = INV_PI *
    (rho_r E(n) + rho_t E(-n))."""
    p = torch.cat([r[0] for r in rps])
    n = torch.cat([r[1] for r in rps])
    rho_r = torch.cat([r[2] for r in rps])
    rho_t = torch.cat([r[3] for r in rps])

    def e_all(pb, nn):
        return (pmap.ephoton(direct_m, pb, nn, n_lookup, max_dist2)
                + pmap.ephoton(indirect_m, pb, nn, n_lookup, max_dist2)
                + pmap.ephoton(caustic_m, pb, nn, n_lookup, max_dist2))

    los = []
    for s in range(0, p.shape[0], RADIANCE_CHUNK):
        e = slice(s, s + RADIANCE_CHUNK)
        los.append((1.0 / math.pi) * (rho_r[e] * e_all(p[e], n[e]) + rho_t[e] * e_all(p[e], -n[e])))
    info(f"radiance map: {p.shape[0]} photons")
    return pmap.build_radiance_map(p, torch.cat(los), n, cell, device=p.device)
