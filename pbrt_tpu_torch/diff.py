"""Differentiable rendering: scene-parameter gradients end to end.

Port of pbrt_tpu/diff.py. Gradients with respect to volume sigma_a /
sigma_s, light power and per-material diffuse albedo flow through the
path tracer, the volume march and the photon splat by torch autograd:

- `DiffParams` names the differentiable leaves (tensors the caller
  marks with requires_grad);
- `apply_params(scene, params)` substitutes them into the compiled
  scene's tensors (every integrator reads the substituted tensors);
- `freeze_photon_shoot` / `diff_photon_ctx` make the photon pipeline
  differentiable: a first shoot freezes the discrete structure (which
  paths deposited which photons where, and each map's sorted grid),
  then the shoot is traced again with the parameters and the photon
  powers are gathered at the frozen indices. Gradients flow from a kNN
  density estimate back through the map's powers -> the deposit's path
  throughput -> light power / albedo / phase weights.

Discrete events stay detached, as in the JAX package: Woodcock
acceptance, Russian roulette survival, absorb or scatter, lobe picks and
the kNN neighbour sets are comparisons, which carry no gradient; the
continuous factors carry it. The light pick CDF (`light_dist`) stays
frozen (a sampling distribution, so the estimator stays unbiased), and
environment maps are not scaled. The intersection kernels return
(t, prim) as constants of the graph: no parameter reaches ray geometry.
"""
from __future__ import annotations

from dataclasses import replace as dc_replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.photon.map import build_photon_map_from, photon_map_structure
from pbrt_tpu_torch.photon.shooter import PhotonCtx, compute_majorant, shoot_batch_fn

S = spec.N_BINS


class DiffParams(NamedTuple):
    """Differentiable scene parameters (None = leave the scene's own).

    sigma_a / sigma_s: [V, S] volume coefficients (VolumeT rows).
    light_scale:       [L] per-light power scale (1.0 = as authored).
    kd_scale:          [M, S] per-material diffuse-albedo scale.
    """

    sigma_a: Optional[torch.Tensor] = None
    sigma_s: Optional[torch.Tensor] = None
    light_scale: Optional[torch.Tensor] = None
    kd_scale: Optional[torch.Tensor] = None


def _device(scene):
    return scene.geom.tri_v0.device


def default_params(scene, want=("sigma_a", "sigma_s", "light_scale", "kd_scale")) -> DiffParams:
    """Identity-valued parameters of the scene's shapes, on its device
    (copies: marking them requires_grad leaves the scene as it is)."""
    dev = _device(scene)
    kw = {}
    if scene.volume is not None:
        if "sigma_a" in want:
            kw["sigma_a"] = scene.volume.sigma_a.clone()
        if "sigma_s" in want:
            kw["sigma_s"] = scene.volume.sigma_s.clone()
    if scene.lights is not None and "light_scale" in want:
        kw["light_scale"] = torch.ones((scene.n_lights,), device=dev)
    if "kd_scale" in want:
        kw["kd_scale"] = torch.ones((len(scene.materials), S), device=dev)
    return DiffParams(**kw)


def apply_params(scene, params: DiffParams):
    """The scene with the parameters substituted (a shallow copy; the
    scene itself is unchanged). Light scale multiplies the sampled
    radiance and the power table; the pick CDF stays frozen."""
    out = scene
    vol = scene.volume
    if vol is not None and (params.sigma_a is not None or params.sigma_s is not None):
        vol = vol._replace(
            sigma_a=(vol.sigma_a if params.sigma_a is None
                     else torch.broadcast_to(params.sigma_a, vol.sigma_a.shape)),
            sigma_s=(vol.sigma_s if params.sigma_s is None
                     else torch.broadcast_to(params.sigma_s, vol.sigma_s.shape)))
        out = dc_replace(out, volume=vol)
    if scene.lights is not None and params.light_scale is not None:
        ls = params.light_scale[:, None]
        out = dc_replace(out, lights=scene.lights._replace(
            spectra=scene.lights.spectra * ls, power=scene.lights.power * ls))
    if params.kd_scale is not None:
        out = dc_replace(out, kd_scale=params.kd_scale)
    return out


class FrozenShoot(NamedTuple):
    """Concrete record of one photon-shooting run: enough to trace the
    identical paths again with parameters and rebuild the maps
    differentiably. Produced by freeze_photon_shoot."""

    n_batches: int
    B: int                 # lanes per batch
    seed: int
    max_depth: int
    has_volume: bool
    majorant: float        # static Woodcock majorant (detached control)
    # per class code (1 caustic, 2 indirect, 3 direct, 4 volume): flat
    # indices into the [n_batches * B * D] records, concrete pos / wi,
    # the map's structure and the nshot normalizer; None where empty
    classes: dict          # code -> (idx, pos, wi, MapStructure, nshot)
    cfg: dict              # n_used / max_dist2 / vol_n_used / vol_max_dist2


_CLASS_CODES = {"caustic": 1, "indirect": 2, "direct": 3, "volume": 4}


def freeze_photon_shoot(scene, n_paths: int, vol_quota: int = 0, seed: int = 0,
                        max_depth: int = 5, n_used: int = 50, max_dist: float = 0.1,
                        vol_n_used: int = 30, vol_max_dist: float = 0.1) -> FrozenShoot:
    """Shoot `n_paths` photon paths and freeze the discrete outcome (a
    fixed-count analog of build_photon_maps: quotas are replaced by a
    fixed path count, so the second trace is the same program)."""
    has_volume = scene.volume is not None and vol_quota > 0
    majorant = compute_majorant(scene, has_volume)
    batch_fn = shoot_batch_fn(scene, max_depth, has_volume, sig_majorant=majorant)
    dev = _device(scene)
    B = min(n_paths, 8192)
    n_batches = max(1, -(-n_paths // B))
    recs = {k: [] for k in ("pos", "alpha", "wi", "cls")}
    lane = torch.arange(B, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for bi in range(n_batches):
            r = batch_fn(lane, torch.full((B,), bi * B, dtype=torch.int64, device=dev), seed)
            for k in recs:
                recs[k].append(r[k].reshape((-1,) + r[k].shape[2:]).cpu().numpy())
    pos, al, wi, cls = (np.concatenate(recs[k]) for k in ("pos", "alpha", "wi", "cls"))
    nz = al.sum(-1) > 0
    nshot = n_batches * B

    classes = {}
    for code in _CLASS_CODES.values():
        idx = np.nonzero(nz & (cls == code))[0]
        if len(idx) == 0:
            classes[code] = None
            continue
        cell = vol_max_dist if code == 4 else (max_dist if code == 1 else max_dist * 2.0)
        k = vol_n_used if code == 4 else n_used
        st = photon_map_structure(pos[idx], cell, target_k=k)
        classes[code] = (idx, pos[idx], wi[idx], st, nshot)

    return FrozenShoot(
        n_batches=n_batches, B=B, seed=seed, max_depth=max_depth, has_volume=has_volume,
        majorant=majorant, classes=classes,
        cfg=dict(n_used=n_used, max_dist2=max_dist * max_dist, vol_n_used=vol_n_used,
                 vol_max_dist2=vol_max_dist * vol_max_dist))


def diff_photon_ctx(scene_p, frozen: FrozenShoot) -> PhotonCtx:
    """Trace the frozen shoot again with the parameters and assemble
    photon maps whose powers carry gradients. scene_p must be
    `apply_params(scene, params)` of the scene frozen against: the
    counter-based sampler reproduces the same paths, so the frozen
    indices select the same deposits."""
    dev = _device(scene_p)
    batch_fn = shoot_batch_fn(scene_p, frozen.max_depth, frozen.has_volume,
                              sig_majorant=frozen.majorant)
    lane = torch.arange(frozen.B, dtype=torch.int64, device=dev)
    als = []
    for bi in range(frozen.n_batches):
        shot = torch.full((frozen.B,), bi * frozen.B, dtype=torch.int64, device=dev)
        als.append(batch_fn(lane, shot, frozen.seed)["alpha"].reshape(-1, S))
    al_flat = torch.cat(als) if len(als) > 1 else als[0]

    maps = {}
    for code, entry in frozen.classes.items():
        if entry is None:
            maps[code] = None
            continue
        idx, pos, wi, st, nshot = entry
        a = al_flat[torch.as_tensor(idx, device=dev)] / float(max(nshot, 1))
        maps[code] = build_photon_map_from(st, pos, a, wi, dev)

    c = frozen.cfg
    paths = frozen.n_batches * frozen.B
    return PhotonCtx(
        caustic=maps.get(1), indirect=maps.get(2), volume=maps.get(4), direct=maps.get(3),
        radiance=None, n_caustic_paths=paths, n_indirect_paths=paths, n_volume_paths=paths,
        n_used=c["n_used"], max_dist2=c["max_dist2"], vol_n_used=c["vol_n_used"],
        vol_max_dist2=c["vol_max_dist2"], final_gather=False, gather_samples=1,
        cos_gather_angle=0.9848, max_specular_depth=frozen.max_depth,
        max_photon_depth=frozen.max_depth)
