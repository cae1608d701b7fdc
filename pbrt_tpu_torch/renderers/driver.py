"""Render driver: the SamplerRenderer analog.

Port of the sampler path of pbrt_tpu/renderers/driver.py (reference
renderers/samplerrenderer.cpp:190-249). The image is cut into tiles of
camera samples (65536 by default, 16384 when a photon integrator runs);
each tile runs camera raygen -> surface Li -> volume Li -> filtered film
deposit on the scene's device, and tiles stream on the host. The photon
integrators' maps are built once, before the first tile, and passed to
them as an argument. The adaptive sampler renders a tile in two passes
(render_tile). The film accumulators can be checkpointed every
`checkpoint_every` tiles to an npz file and a render resumed from it
(the JAX package's fields and compatibility check). The probes counters
tick once per tile. A realistic camera with AF zones focuses before the
first tile. The surfacepoints and createprobes renderers write their
point and probe files instead of an image; the metropolis renderer
(renderers/metropolis.py) returns its image, and aggregatetest
(renderers/aggregatetest.py) the count of its mismatches.
"""
from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum
from pbrt_tpu_torch.core.error import PbrtError, info, progress, warning
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.core.sampling import mul32
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.cameras.cameras import CAM_REALISTIC, make_camera
from pbrt_tpu_torch.film import film as film_mod
from pbrt_tpu_torch.integrators import extra
from pbrt_tpu_torch.integrators import photonmap as photonmap_int
from pbrt_tpu_torch.integrators import photonvolume as photonvolume_int
from pbrt_tpu_torch.integrators import surface as surf_int
from pbrt_tpu_torch.integrators import volume as vol_int
from pbrt_tpu_torch.parallel import mesh as pmesh
from pbrt_tpu_torch.photon import shooter
from pbrt_tpu_torch.samplers.samplers import (
    S_ADAPTIVE,
    adaptive_needs,
    adaptive_needs_shapeid,
    camera_samples,
    make_sampler,
)
from pbrt_tpu_torch.scene.compile import CompiledScene, compile_scene
from pbrt_tpu_torch.scene.records import RenderOptions

DEFAULT_TILE_SAMPLES = 1 << 16
# photon integrators carry far more per-lane state (kNN candidate
# buffers, lookups inside the march), so their default tile is smaller
PHOTON_TILE_SAMPLES = 1 << 14
PHOTON_SURF = ("photonmap", "exphotonmap")
SURFACE_INTEGRATORS = ("path", "directlighting", "whitted", "ambientocclusion", "igi",
                       "irradiancecache", "dipolesubsurface", "diffuseprt", "glossyprt",
                       "useprobes") + PHOTON_SURF
# the dipole's scattering coefficients when no subsurface material has them
DIPOLE_SIGMA_A_RGB = (0.0011, 0.0024, 0.014)
DIPOLE_SIGMA_PS_RGB = (2.55, 3.21, 3.77)
BIG = 1e30
M32 = 0xFFFFFFFF
# what the last render_sampler measured (read by tests and chip_smoke.py):
# tiles, start_tile (a resumed render starts past 0), adaptive_vetoed
# (pixels the adaptive veto sent to the second pass)
last_stats: dict = {}


def render_scene(ro: RenderOptions, options: Optional[dict] = None):
    """Parse-complete hook: compile the scene and render it (reference
    pbrtWorldEnd -> MakeRenderer -> Render). options["device"] names the
    torch device ("cuda" by default)."""
    options = dict(options or {})
    device = torch.device(options.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise PbrtError("no CUDA device available; pass device='cpu' to render on the CPU")
    scene = compile_scene(ro, device)
    filter_spec = film_mod.make_filter(ro.filter_name, ro.filter_params)
    film = film_mod.make_film(ro.film_name, ro.film_params, filter_spec, options)
    camera = make_camera(ro.camera_name, ro.camera_params,
                         ro.camera_to_world or Transform(), film.xres, film.yres)
    sampler = make_sampler(ro.sampler_name, ro.sampler_params, options)
    if ro.renderer_name == "metropolis":
        from pbrt_tpu_torch.renderers.metropolis import render_metropolis

        return render_metropolis(scene, ro, film, camera, options)
    if ro.renderer_name == "aggregatetest":
        from pbrt_tpu_torch.renderers.aggregatetest import run_aggregate_test

        return run_aggregate_test(scene, ro, options)
    if ro.renderer_name == "surfacepoints":
        from pbrt_tpu_torch.renderers.surfacepoints import render_surface_points

        return render_surface_points(scene, ro, options)
    if ro.renderer_name == "createprobes":
        from pbrt_tpu_torch.renderers.createprobes import render_create_probes

        return render_create_probes(scene, ro, options)
    if ro.renderer_name != "sampler":
        warning(f'Renderer "{ro.renderer_name}" unknown; using "sampler".')
    return render_sampler(scene, ro, film, camera, sampler, options)


def position_hash_u(p):
    """A uniform in [0, 1) per point from the bits of p * 4096 (float32
    bit-cast to uint32, multiplies wrapping mod 2^32, done in int64)."""
    bits = (p.to(torch.float32) * 4096.0).contiguous().view(torch.int32).to(torch.int64) & M32
    h = mul32(bits[:, 0], 0x9E3779B9)
    h = h ^ mul32(bits[:, 1], 0x85EBCA6B)
    h = h ^ mul32(bits[:, 2], 0xC2B2AE35)
    h = h ^ (h >> 16)
    h = mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _make_transmittance_fn(scene: CompiledScene, n_steps: int):
    if scene.volume is None:
        return None

    def fn(p, wi, dist):
        # the march's offset jitter comes from a position hash:
        # deterministic per shading point, decorrelated across points
        return vol_int.transmittance(scene.volume, p, wi, dist, n_steps, position_hash_u(p))

    return fn


def build_li_fn(scene: CompiledScene, ro: RenderOptions, options: dict):
    """Compose surface + volume Li into one wavefront radiance fn
    (reference samplerrenderer.cpp:228-249 SamplerRenderer::Li:
    return T * Li_surface + Li_volume). Integrator names the JAX package
    knows and this package does not were refused by compile_scene;
    names neither knows warn and fall back as the JAX package does."""
    sname, sp = ro.surf_integrator_name, ro.surf_integrator_params
    vname, vp = ro.vol_integrator_name, ro.vol_integrator_params
    quick = bool(options.get("quick"))
    max_depth = sp.find_one_int("maxdepth", 5)
    step_size = vp.find_one_float("stepsize", 1.0)
    n_steps = 16
    if scene.volume is not None:
        n_steps = vol_int.pick_n_steps(scene.volume, step_size, cap=32 if quick else 128)
    trans_fn = _make_transmittance_fn(scene, max(4, n_steps // 2))
    if sname not in SURFACE_INTEGRATORS:
        warning(f'SurfaceIntegrator "{sname}" unknown; using "path".')
        sname = "path"
    if scene.volume is not None and vname not in ("none", "emission", "single", "photonvolume"):
        warning(f'VolumeIntegrator "{vname}" unknown; using "single".')
        vname = "single"
    seed0 = int(options.get("seed", 0))
    ctx = None
    if uses_photons(ro):
        ctx = shooter.build_photon_maps(scene, sp, vp, options)
    vpls = points = probes = sigma = None
    if sname == "igi":
        n_lights = sp.find_one_int("nlights", 64)
        if quick:
            n_lights = max(4, n_lights // 8)
        vpls = extra.generate_vpls(scene, sp.find_one_int("nsets", 4), max(1, n_lights // 4),
                                   max_depth, seed0)
    elif sname == "dipolesubsurface":
        points = _dipole_points(scene, sp, seed0)
        sigma = _dipole_sigma(scene)
    elif sname == "useprobes":
        from pbrt_tpu_torch.renderers.createprobes import load_probes

        fn = sp.find_one_string("filename", "probes.npz")
        try:
            probes = load_probes(fn, scene.geom.tri_v0.device)
        except OSError as e:
            warning(f"useprobes: cannot load {fn}: {e}")

    def surface_li(ray, pixel, sidx, seed):
        if sname in PHOTON_SURF:
            return photonmap_int.li_photonmap(scene, ctx, ray, pixel, sidx, max_depth=max_depth,
                                              seed=seed, transmittance_fn=trans_fn)
        if sname == "directlighting":
            return surf_int.li_direct(scene, ray, pixel, sidx, max_depth=max_depth, seed=seed,
                                      strategy=sp.find_one_string("strategy", "all"),
                                      transmittance_fn=trans_fn)
        if sname == "whitted":
            return surf_int.li_whitted(scene, ray, pixel, sidx, max_depth=max_depth,
                                       seed=seed, transmittance_fn=trans_fn)
        if sname == "ambientocclusion":
            ns = sp.find_one_int("nsamples", 16 if quick else 2048)
            return surf_int.li_ao(scene, ray, pixel, sidx, n_samples=min(ns, 64),
                                  max_dist=sp.find_one_float("maxdist", BIG), seed=seed)
        if sname == "igi":
            return extra.li_igi(scene, vpls, ray, pixel, sidx, max_depth=max_depth,
                                g_limit=sp.find_one_float("glimit", 10.0), seed=seed,
                                transmittance_fn=trans_fn)
        if sname == "irradiancecache":
            ns = sp.find_one_int("nsamples", 4096)
            return extra.li_irradiance(scene, ray, pixel, sidx,
                                       n_samples=min(max(ns // 256, 4), 32), seed=seed,
                                       transmittance_fn=trans_fn)
        if sname == "dipolesubsurface":
            return extra.li_dipole(scene, points, ray, pixel, sidx, sigma_a=sigma[0],
                                   sigma_ps=sigma[1], scale=sp.find_one_float("scale", 1.0),
                                   seed=seed, transmittance_fn=trans_fn)
        if sname == "diffuseprt":
            # the scene's nsamples (reference default 4096), capped: the
            # transfer is evaluated again for every camera sample
            ns = 8 if quick else min(64, max(16, sp.find_one_int("nsamples", 4096) // 64))
            return extra.li_diffuseprt(scene, ray, pixel, sidx, lmax=sp.find_one_int("lmax", 4),
                                       n_samples=ns, seed=seed)
        if sname == "glossyprt":
            return extra.li_glossyprt(scene, ray, pixel, sidx, lmax=sp.find_one_int("lmax", 4),
                                      roughness=sp.find_one_float("roughness", 0.1), seed=seed)
        if sname == "useprobes":
            return extra.li_useprobes(scene, probes, ray, pixel, sidx, seed=seed)
        return surf_int.li_path(scene, ray, pixel, sidx, max_depth=max_depth, seed=seed,
                                transmittance_fn=trans_fn)

    def volume_li(ray, t_surf, pixel, sidx, seed):
        if vname == "emission":
            return vol_int.li_emission(scene.volume, ray, t_surf, pixel, sidx, n_steps, seed)
        if vname == "photonvolume":
            return photonvolume_int.li_photonvolume(scene, ctx, ray, t_surf, pixel, sidx,
                                                    n_steps, seed)
        return vol_int.li_single(scene, ray, t_surf, pixel, sidx, n_steps, seed)

    def li(ray: Ray, pixel, sidx, seed: int):
        L_surf = surface_li(ray, pixel, sidx, seed)
        if scene.volume is None or vname == "none":   # Tr = 1, L_volume = 0
            return L_surf
        hit_t, _prim = first_hit_t(scene, ray)
        vr = volume_li(ray, hit_t, pixel, sidx, seed)
        return vr.Tr * L_surf + vr.L

    return li


def _dipole_points(scene: CompiledScene, sp, seed: int):
    """dipolesubsurface's surface points (from "pointsfile", else made
    at "minsampledistance") with their irradiance."""
    from pbrt_tpu_torch.renderers.surfacepoints import generate_surface_points

    mind = sp.find_one_float("minsampledistance", 0.25)
    pfile = sp.find_one_string("pointsfile", "")
    if pfile:
        z = np.load(pfile)
        p, n, a = z["p"], z["n"], z["area"]
    else:
        p, n, a = generate_surface_points(scene, mind, seed)
    dev = scene.geom.tri_v0.device
    pts = extra.SurfacePoints(p=torch.as_tensor(p, device=dev), n=torch.as_tensor(n, device=dev),
                              area=torch.as_tensor(a, device=dev),
                              E=torch.zeros((len(p), spectrum.N_BINS), device=dev))
    return extra.compute_point_irradiance(scene, pts, seed)


def _dipole_sigma(scene: CompiledScene):
    """(sigma_a, sigma'_s) spectra of the first subsurface material that
    carries them, else the JAX package's defaults."""
    for m in scene.materials:
        if m.kind in ("subsurface", "kdsubsurface") and "sigma_a" in m.spectra:
            return m.spectra["sigma_a"], m.spectra["sigma_prime_s"]
    return (spectrum.from_rgb(np.asarray(DIPOLE_SIGMA_A_RGB, np.float32)),
            spectrum.from_rgb(np.asarray(DIPOLE_SIGMA_PS_RGB, np.float32)))


def uses_photons(ro: RenderOptions) -> bool:
    return ro.surf_integrator_name in PHOTON_SURF or ro.vol_integrator_name == "photonvolume"


def first_hit_t(scene: CompiledScene, ray: Ray):
    """The camera rays' first hit (t, BIG on a miss; prim), by a second
    traversal of the same rays."""
    hit = scene.intersect(ray, coherent=True)
    return torch.where(hit.valid, hit.t, torch.full((), BIG, device=hit.t.device)), hit.prim


def render_tile(scene: CompiledScene, film, camera, sampler, li_fn, state, pix_ids,
                seed: int, n_real: Optional[int] = None):
    """One tile of pixels [P] into the film state. Returns the number of
    vetoed pixels among the first n_real (a device tensor) for the
    adaptive sampler, else None.

    Adaptive (reference samplers/adaptive.cpp:182-185 ReportResults):
    minsamples first; pixels the contrast (or shape-id) veto fails
    discard those samples and re-render at maxsamples with seed + 1,
    where the lanes of passing pixels get an empty ray interval (tmax
    -1) and zero weight. The surface integrators rebuild each bounce's
    interval, so those lanes are traced all the same, as in the JAX
    package (ROADMAP R19); the zero weight drops them."""
    device = pix_ids.device
    P = pix_ids.shape[0]
    pix_x = (pix_ids % film.nx) + film.x0
    pix_y = (pix_ids // film.nx) + film.y0
    spp = sampler.spp
    if sampler.kind == S_ADAPTIVE:
        spec_min = dataclasses.replace(sampler, spp=max(1, sampler.adaptive_min))
        spp_min = spec_min.spp
        cs1 = camera_samples(spec_min, pix_x, pix_y, film.xres, seed)
        ray1, rw1 = camera.generate_rays(cs1.px, cs1.py, cs1.u_lens1, cs1.u_lens2, cs1.u_time)
        sidx1 = torch.arange(spp_min, dtype=torch.int64, device=device).repeat(P)
        L1 = torch.nan_to_num(li_fn(ray1, cs1.pixel, sidx1, seed), nan=0.0, posinf=0.0,
                              neginf=0.0)
        if sampler.adaptive_method == "shapeid":
            # geometric-discontinuity veto: the pixel's samples hit
            # different prims
            needs = adaptive_needs_shapeid(first_hit_t(scene, ray1)[1], P, spp_min)
        else:
            needs = adaptive_needs(spectrum.y(L1), P, spp_min)
        cs = camera_samples(sampler, pix_x, pix_y, film.xres, seed + 1)
        ray, rw = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
        needs_r = torch.repeat_interleave(needs, spp)
        ray = Ray(ray.o, ray.d, ray.tmin,
                  torch.where(needs_r, ray.tmax, torch.full((), -1.0, device=device)), ray.time)
        sidx = torch.arange(spp, dtype=torch.int64, device=device).repeat(P)
        L = torch.nan_to_num(li_fn(ray, cs.pixel, sidx, seed), nan=0.0, posinf=0.0,
                             neginf=0.0)
        film_mod.add_samples(film, state, cs1.px, cs1.py, L1,
                             rw1 * ~torch.repeat_interleave(needs, spp_min))
        film_mod.add_samples(film, state, cs.px, cs.py, L, rw * needs_r)
        return needs[:P if n_real is None else n_real].sum()
    cs = camera_samples(sampler, pix_x, pix_y, film.xres, seed)
    ray, rw = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
    sidx = torch.arange(spp, dtype=torch.int64, device=device).repeat(P)
    L = li_fn(ray, cs.pixel, sidx, seed)
    # reference samplerrenderer.cpp:119-133 black-pixel fallback for NaN/inf
    L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    film_mod.add_samples(film, state, cs.px, cs.py, L, rw)
    return None


def _resume(path: str, film, spp: int, seed: int, state) -> int:
    """Load a checkpoint into the film state if it is compatible with
    this render (same film shape, spp and seed); -> the tile to start at."""
    if not (path and os.path.exists(path)):
        return 0
    z = np.load(path)
    if (tuple(z["shape"]) == (film.ny, film.nx) and int(z["spp"]) == spp
            and int(z["seed"]) == seed):
        state.xyz.copy_(torch.as_tensor(z["xyz"]))
        state.weight.copy_(torch.as_tensor(z["weight"]))
        return int(z["tile"])
    warning("checkpoint incompatible with this render; ignoring")
    return 0


@probes.spanned("render/frame")
def render_sampler(scene: CompiledScene, ro: RenderOptions, film, camera, sampler,
                   options: dict):
    """The tile-streaming render loop, with checkpoint/resume of the
    film accumulators (options "checkpoint", "checkpoint_every")."""
    li_fn = build_li_fn(scene, ro, options)
    seed = int(options.get("seed", 0))
    spp = sampler.spp
    device = scene.geom.tri_v0.device
    if camera.kind == CAM_REALISTIC and camera.lens.af_zones:
        # reference samplerrenderer.cpp:202 camera->AutoFocus
        from pbrt_tpu_torch.cameras.realistic import autofocus

        autofocus(scene, camera, film, li_fn, seed=seed, spp=4 if options.get("quick") else 16)
    tile_samples = int(options.get("tile_samples")
                       or (PHOTON_TILE_SAMPLES if uses_photons(ro) else DEFAULT_TILE_SAMPLES))
    pix_per_tile = max(1, tile_samples // spp)
    # sharded over a process group: each rank renders its slice of every
    # tile into its own film accumulators, reduced before any write
    mesh = pmesh.mesh_from_options(options)
    pix_per_tile = pmesh.round_to_world(mesh, pix_per_tile)
    if mesh is not None:
        info(f"sharding render tiles over {mesh.world} ranks")
    n_pix = film.nx * film.ny
    n_tiles = (n_pix + pix_per_tile - 1) // pix_per_tile

    state = film_mod.init_state(film, device)
    ckpt_path = options.get("checkpoint")
    ckpt_every = int(options.get("checkpoint_every", 64))
    start_tile = _resume(ckpt_path, film, spp, seed, state)
    if mesh is not None:
        # rank 0's checkpoint holds the reduced film: it alone keeps it,
        # and every rank starts at its tile
        if mesh.rank != 0:
            state = film_mod.init_state(film, device)
        start_tile = int(pmesh.reduce_sum(mesh, [torch.tensor(
            [start_tile if mesh.rank == 0 else 0], dtype=torch.int64, device=device)])[0])
    if start_tile:
        info(f"resuming render from checkpoint tile {start_tile}/{n_tiles}")
    vetoed = torch.zeros((), dtype=torch.int64, device=device)
    t_start = _time.time()
    all_ids = np.arange(n_pix, dtype=np.int64)
    for ti in range(start_tile, n_tiles):
        ids = all_ids[ti * pix_per_tile: (ti + 1) * pix_per_tile]
        n_real = len(ids)
        if n_real < pix_per_tile:
            # pad with the last pixel, as the reference does to keep one
            # tile shape; the duplicate deposits cancel in the weight
            # normalization of that pixel
            ids = np.concatenate([ids, np.full(pix_per_tile - n_real, ids[-1], np.int64)])
        if mesh is not None:
            ids = pmesh.shard_batch(mesh, ids)
            n_real = min(max(n_real - mesh.rank * len(ids), 0), len(ids))
        with probes.scope("render/tile"):
            with probes.scope("sync/tile_ids"):
                pix_ids = torch.as_tensor(ids, device=device)
            v = render_tile(scene, film, camera, sampler, li_fn, state, pix_ids, seed, n_real)
        if v is not None:
            vetoed = vetoed + v
        probes.count("render/tiles")
        probes.count("render/camera_samples", n_real * spp)
        if ckpt_path and (ti + 1) % ckpt_every == 0 and ti + 1 < n_tiles:
            xyz, weight = state.xyz, state.weight
            if mesh is not None:
                xyz, weight = pmesh.reduce_sum(mesh, [xyz, weight])
            if mesh is None or mesh.rank == 0:
                np.savez(ckpt_path, xyz=xyz.cpu().numpy(), weight=weight.cpu().numpy(),
                         tile=ti + 1, shape=(film.ny, film.nx), spp=spp, seed=seed)
        progress("Rendering", ti + 1, n_tiles, t_start)
    if mesh is not None:
        state = film_mod.FilmState(*pmesh.reduce_sum(mesh, list(state)))
        vetoed = pmesh.reduce_sum(mesh, [vetoed])[0]
    with probes.scope("sync/vetoed"):
        n_vetoed = int(vetoed)
    last_stats.clear()
    last_stats.update(tiles=n_tiles - start_tile, start_tile=start_tile,
                      adaptive_vetoed=n_vetoed)

    if options.get("write", True):
        rgb = film_mod.write_image(film, state)
    else:
        rgb = film_mod.to_rgb(film, state)
    dt = max(_time.time() - t_start, 1e-9)
    info(f"render finished in {dt:.2f}s ({n_pix * spp / dt:.0f} samples/s)")
    return rgb
