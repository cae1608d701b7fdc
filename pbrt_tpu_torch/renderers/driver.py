"""Render driver: the SamplerRenderer analog.

Port of the sampler path of pbrt_tpu/renderers/driver.py (reference
renderers/samplerrenderer.cpp:190-249). The image is cut into tiles of
camera samples (65536 by default); each tile runs camera raygen ->
path Li -> filtered film deposit on the scene's device, and tiles
stream on the host.
"""
from __future__ import annotations

import time as _time
from typing import Optional

import numpy as np
import torch

from pbrt_tpu_torch.core.error import PbrtError, info, progress, warning
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.cameras.cameras import make_camera
from pbrt_tpu_torch.film import film as film_mod
from pbrt_tpu_torch.integrators.surface import li_path
from pbrt_tpu_torch.samplers.samplers import camera_samples, make_sampler
from pbrt_tpu_torch.scene.compile import CompiledScene, compile_scene
from pbrt_tpu_torch.scene.records import RenderOptions

DEFAULT_TILE_SAMPLES = 1 << 16


def render_scene(ro: RenderOptions, options: Optional[dict] = None):
    """Parse-complete hook: compile the scene and render it (reference
    pbrtWorldEnd -> MakeRenderer -> Render). options["device"] names the
    torch device ("cuda" by default)."""
    options = dict(options or {})
    device = torch.device(options.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise PbrtError("no CUDA device available; pass device='cpu' to render on the CPU")
    scene = compile_scene(ro, device)  # raises on what is not yet ported
    if ro.renderer_name != "sampler":
        warning(f'Renderer "{ro.renderer_name}" unknown; using "sampler".')
    filter_spec = film_mod.make_filter(ro.filter_name, ro.filter_params)
    film = film_mod.make_film(ro.film_name, ro.film_params, filter_spec, options)
    camera = make_camera(ro.camera_name, ro.camera_params,
                         ro.camera_to_world or Transform(), film.xres, film.yres)
    sampler = make_sampler(ro.sampler_name, ro.sampler_params, options)
    return render_sampler(scene, ro, film, camera, sampler, options)


def render_sampler(scene: CompiledScene, ro: RenderOptions, film, camera, sampler,
                   options: dict):
    """The tile-streaming render loop."""
    if ro.surf_integrator_name != "path":
        warning(f'SurfaceIntegrator "{ro.surf_integrator_name}" unknown; using "path".')
    max_depth = ro.surf_integrator_params.find_one_int("maxdepth", 5)
    seed = int(options.get("seed", 0))
    spp = sampler.spp
    device = scene.geom.tri_v0.device
    tile_samples = int(options.get("tile_samples") or DEFAULT_TILE_SAMPLES)
    pix_per_tile = max(1, tile_samples // spp)
    n_pix = film.nx * film.ny
    n_tiles = (n_pix + pix_per_tile - 1) // pix_per_tile

    state = film_mod.init_state(film, device)
    t_start = _time.time()
    all_ids = np.arange(n_pix, dtype=np.int64)
    for ti in range(n_tiles):
        ids = all_ids[ti * pix_per_tile: (ti + 1) * pix_per_tile]
        if len(ids) < pix_per_tile:
            # pad with the last pixel, as the reference does to keep one
            # tile shape; the duplicate deposits cancel in the weight
            # normalization of that pixel
            ids = np.concatenate([ids, np.full(pix_per_tile - len(ids), ids[-1], np.int64)])
        ids_dev = torch.as_tensor(ids, device=device)
        pix_x = (ids_dev % film.nx) + film.x0
        pix_y = (ids_dev // film.nx) + film.y0
        cs = camera_samples(sampler, pix_x, pix_y, film.xres, seed)
        ray, rw = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
        sidx = torch.arange(spp, dtype=torch.int64, device=device).repeat(len(ids))
        L = li_path(scene, ray, cs.pixel, sidx, max_depth=max_depth, seed=seed)
        # reference samplerrenderer.cpp:119-133 black-pixel fallback for NaN/inf
        L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
        film_mod.add_samples(film, state, cs.px, cs.py, L, rw)
        progress("Rendering", ti + 1, n_tiles, t_start)

    if options.get("write", True):
        rgb = film_mod.write_image(film, state)
    else:
        rgb = film_mod.to_rgb(film, state)
    dt = max(_time.time() - t_start, 1e-9)
    info(f"render finished in {dt:.2f}s ({n_pix * spp / dt:.0f} samples/s)")
    return rgb
