"""Metropolis light transport (Kelemen primary-sample-space MLT).

Port of pbrt_tpu/renderers/metropolis.py (reference renderers/
metropolis.cpp): a wavefront of W = 4096 chains in lockstep, whatever
the device. Each chain's state is its primary-sample vector u in
[0,1)^D (D = the dims a path of maxdepth bounces consumes, bidirectional
or not). One step mutates all chains (a large step with probability
largestepprobability, else the exponential small-step jitter of
:106-130), evaluates the path contribution (integrators/bidir.py),
splats the current and the proposed path with their expected-value
weights (Veach-style) and accepts or rejects each chain. The
normalisation b comes from a bootstrap of n_bootstrap // W batches of
uniform vectors; the chains start from W vectors resampled from the
bootstrap in proportion to their luminance, regenerated from the
stored batch keys. Every random number is drawn through core/threefry.py,
so the draws equal the JAX package's. maxconsecutiverejects is read and
unused, as in the JAX package: lockstep chains with expected-value
splats cannot wedge the way serial chains do.
"""
from __future__ import annotations

import math
import time as _time

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core import threefry
from pbrt_tpu_torch.core.error import info, progress
from pbrt_tpu_torch.film import film as film_mod

W_CHAINS = 4096   # chains in flight
# the small step's jitter: magnitude b * (a / b)^eps, a = 1/1024, b = 1/64
SMALL_A, SMALL_B = 1.0 / 1024.0, 1.0 / 64.0
# what the last render_metropolis did (read by chip_smoke.py): steps,
# chains, dims, bootstrap paths, b, accepted proposals, splat_scale and
# the splats' summed luminance (CIE Y, before the scale)
last_stats: dict = {}


def render_metropolis(scene, ro, film, camera, options=None):
    """reference metropolis.cpp Render: bootstrap -> chains -> splat.
    Supports the bidirectional option (default true, :521) and the
    separate direct-lighting pass (dodirectseparately, :518): direct
    light rendered at `directsamples` spp through the film's AddSample
    path while the chains splat the remaining transport."""
    from pbrt_tpu_torch.integrators.bidir import n_psample_dims, path_l_psamples

    options = options or {}
    p = ro.renderer_params
    quick = bool(options.get("quick"))
    spp = p.find_one_int("samplesperpixel", 100)
    n_bootstrap = p.find_one_int("bootstrapsamples", 100000)
    largestep_prob = p.find_one_float("largestepprobability", 0.25)
    max_depth = p.find_one_int("maxdepth", 7)
    bidirectional = p.find_one_bool("bidirectional", True)
    do_direct = p.find_one_bool("dodirectseparately", True)
    n_direct = p.find_one_int("directsamples", 4)
    p.find_one_int("maxconsecutiverejects", 512)
    if quick:
        spp = max(1, spp // 10)
        n_bootstrap = max(4096, n_bootstrap // 10)
        n_direct = max(1, n_direct // 4)
    p.report_unused('in renderer "metropolis"')
    max_depth = ro.surf_integrator_params.find_one_int("maxdepth", max_depth)

    device = scene.geom.tri_v0.device
    skip_direct = bool(do_direct and scene.lights is not None)

    def path_l(u):
        return path_l_psamples(scene, camera, film, u, max_depth, bidirectional=bidirectional,
                               skip_direct=skip_direct)

    W = W_CHAINS
    D = n_psample_dims(max_depth, bidirectional)
    n_pix = film.nx * film.ny
    n_steps = max(1, n_pix * spp // W)
    seed = int(options.get("seed", 0))
    key = threefry.prng_key(seed)

    # separate direct-lighting pass (reference metropolis.cpp:532-545: an
    # embedded DirectLightingIntegrator built with the MLT maxdepth, :501)
    state = film_mod.init_state(film, device)
    if skip_direct:
        _render_direct_pass(scene, film, camera, state, max(1, n_direct), seed, max_depth)

    # bootstrap: b = E[luminance] over uniform primary samples
    n_boot_batches = max(1, n_bootstrap // W)
    boot_keys, ys = [], []
    for _ in range(n_boot_batches):
        key, k = threefry.split(key)
        boot_keys.append(k)
        ys.append(spec.y(path_l(threefry.uniform(k, (W, D), device))[2]))
    ys = torch.cat(ys).cpu().numpy()
    b = float(np.mean(ys))
    last_stats.clear()
    last_stats.update(steps=0, chains=W, dims=D, bootstrap_paths=int(ys.shape[0]), b=b,
                      accepted=0, splat_scale=0.0, splat_y=0.0)
    if b <= 0.0:
        info("metropolis: bootstrap found no light-carrying chain paths")
        return _finish(film, state, 0.0, options)

    # seed the chains from the bootstrap distribution: W vectors
    # resampled in proportion to path luminance (the reference walks
    # the luminance CDF for its single seed, :596-608), regenerated from
    # the stored batch keys
    key, ksel = threefry.split(key)
    probs = ys.astype(np.float64)
    probs /= probs.sum()
    idx = threefry.choice(ksel, ys.shape[0], (W,),
                          torch.as_tensor(probs.astype(np.float32), device=device))
    idx = idx.cpu().numpy()
    u0 = torch.empty((W, D), device=device)
    batch_ids, rows = idx // W, idx % W
    for bi in np.unique(batch_ids):
        ub = threefry.uniform(boot_keys[int(bi)], (W, D), device)
        sel = np.nonzero(batch_ids == bi)[0]
        u0[torch.as_tensor(sel, device=device)] = ub[torch.as_tensor(rows[sel], device=device)]

    # the chain carries the current path's evaluation, so each step
    # costs one path_l
    px_c, py_c, L_c = path_l(u0)
    u_cur, y_cur = u0, torch.clamp(spec.y(L_c), min=1e-12)
    accepted = torch.zeros((), dtype=torch.int64, device=device)
    log_ratio = -math.log(SMALL_B / SMALL_A)
    t0 = _time.time()
    for step in range(n_steps):
        key, k = threefry.split(key)
        k1, k2, k3, k4 = threefry.split(k, 4)
        large = threefry.uniform(k1, (W,), device) < largestep_prob
        u_large = threefry.uniform(k2, (W, D), device)
        mag = SMALL_B * torch.exp(log_ratio * threefry.uniform(k3, (W, D), device))
        sign = torch.where(threefry.uniform(k4, (W, D), device) < 0.5, -1.0, 1.0)
        u_small = torch.remainder(u_cur + sign * mag, 1.0)
        u_prop = torch.where(large[:, None], u_large, u_small)

        px_p, py_p, L_p = path_l(u_prop)
        y_p = spec.y(L_p)
        accept_p = torch.clamp(y_p / torch.clamp(y_cur, min=1e-12), 0.0, 1.0)
        # expected-value splats (reference :470-490): the current path
        # with 1 - a, the proposal with a, each over its luminance
        w_c = (1.0 - accept_p) / torch.clamp(y_cur, min=1e-12)
        w_p = accept_p / torch.clamp(y_p, min=1e-12)
        film_mod.splat(film, state, px_c, py_c, L_c * w_c[:, None])
        film_mod.splat(film, state, px_p, py_p, L_p * w_p[:, None])

        acc = threefry.uniform(threefry.fold_in(k, 7), (W,), device) < accept_p
        accepted = accepted + acc.sum()
        u_cur = torch.where(acc[:, None], u_prop, u_cur)
        px_c = torch.where(acc, px_p, px_c)
        py_c = torch.where(acc, py_p, py_c)
        L_c = torch.where(acc[:, None], L_p, L_c)
        y_cur = torch.where(acc, y_p, y_cur)
        progress("Metropolis", step + 1, n_steps, t0)

    # normalisation (reference :737,744 pre-scales each splat by
    # b / nPixelSamples; here at write time): each of the n_steps * W
    # mutations splats unit (L / y)-normalised weight, so the estimator
    # I = b E[L / y] takes the scale b * nPixels / (n_steps * W)
    splat_scale = b * n_pix / float(n_steps * W)
    last_stats.update(steps=n_steps, accepted=int(accepted), splat_scale=splat_scale,
                      splat_y=float(state.splat[..., 1].sum()))
    if skip_direct:
        info("metropolis: direct pass + chain splats combined")
    return _finish(film, state, splat_scale, options)


def _finish(film, state, splat_scale: float, options: dict):
    if options.get("write", True):
        return film_mod.write_image(film, state, splat_scale)
    return film_mod.to_rgb(film, state, splat_scale)


def _render_direct_pass(scene, film, camera, state, spp: int, seed: int, max_depth: int = 5):
    """Direct-lighting pre-pass into state through the AddSample path
    (reference metropolis.cpp doDirectSeparately: an embedded
    DirectLightingIntegrator rendered with an LDSampler at directsamples
    spp, rounded up to a power of two), in tiles of 65,536 samples."""
    from pbrt_tpu_torch.integrators.surface import li_direct
    from pbrt_tpu_torch.samplers.samplers import S_LOWDISCREPANCY, SamplerSpec, camera_samples

    device = state.xyz.device
    spp_p2 = 1 << max(0, (spp - 1).bit_length())
    sampler = SamplerSpec(S_LOWDISCREPANCY, spp_p2)
    n_pix = film.nx * film.ny
    pix_per_tile = max(1, (1 << 16) // spp_p2)
    n_tiles = (n_pix + pix_per_tile - 1) // pix_per_tile
    all_ids = np.arange(n_pix, dtype=np.int64)
    t0 = _time.time()
    for ti in range(n_tiles):
        ids = all_ids[ti * pix_per_tile: (ti + 1) * pix_per_tile]
        if len(ids) < pix_per_tile:
            ids = np.concatenate([ids, np.full(pix_per_tile - len(ids), ids[-1], np.int64)])
        pix_ids = torch.as_tensor(ids, device=device)
        pix_x = (pix_ids % film.nx) + film.x0
        pix_y = (pix_ids // film.nx) + film.y0
        cs = camera_samples(sampler, pix_x, pix_y, film.xres, seed)
        ray, rw = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
        sidx = torch.arange(spp_p2, dtype=torch.int64, device=device).repeat(len(ids))
        L = li_direct(scene, ray, cs.pixel, sidx, max_depth=max_depth, seed=seed, strategy="all")
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        film_mod.add_samples(film, state, cs.px, cs.py, L, rw)
        progress("Direct lighting", ti + 1, n_tiles, t0)
