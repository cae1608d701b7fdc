"""The system under test: pbrt_tpu_torch, driven through its scene API and
its render loop.

Set-up builds the configuration's scene through `scene/api.py` and
compiles it once (`compile_scene`: the shapes, the BVH build, the wide
BVH). Each frame then gets a new film, camera and sampler and runs
`renderers.driver.render_sampler`, the loop the CLI runs, with the
frame's seed and pose (a frame without a pose keeps the scene's own
camera); a frame ends when its RGB is on the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


class PortRenderer:
    def __init__(self, builder, config: dict, traffic: dict, device: str):
        import torch
        from pbrt_tpu_torch.core import error
        from pbrt_tpu_torch.film import film as film_mod
        from pbrt_tpu_torch.scene import api
        from pbrt_tpu_torch.scene.compile import compile_scene
        from pbrt_tpu_torch.scene.paramset import ParamSet

        self.torch, self.device = torch, torch.device(device)
        if api.get_state().state != api.STATE_UNINITIALIZED:
            api.pbrt_cleanup()
        api.pbrt_init({"quiet": True})
        builder.emit_scene(api, ParamSet, config, traffic)
        self.ro = api.get_state().render_options
        api.pbrt_world_end(render=False)
        api.pbrt_cleanup()
        error.quiet = True
        t0 = time.perf_counter()
        self.scene = compile_scene(self.ro, self.device)
        self.sync()
        self.compile_s = time.perf_counter() - t0
        self.filter_spec = film_mod.make_filter(self.ro.filter_name, self.ro.filter_params)
        self.options = {"write": False, "device": str(self.device)}
        if traffic.get("tile_samples"):
            self.options["tile_samples"] = int(traffic["tile_samples"])
        self.samples_per_frame = traffic["xres"] * traffic["yres"] * traffic["spp"]
        self.tile_pixels = int(traffic.get("tile_samples") or (1 << 16)) // traffic["spp"]

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def render(self, frame, one_tile: bool = False) -> np.ndarray:
        """One frame -> its RGB [yres, xres, 3] on the host. `one_tile`
        renders only the rows of the frame's first tile (set-up's warm-up:
        every tile of a frame has the same shapes)."""
        from pbrt_tpu_torch.cameras.cameras import make_camera
        from pbrt_tpu_torch.core.transform import Transform
        from pbrt_tpu_torch.film import film as film_mod
        from pbrt_tpu_torch.renderers.driver import render_sampler
        from pbrt_tpu_torch.samplers.samplers import make_sampler

        ro = self.ro
        opts = dict(self.options, seed=frame.seed)
        film = film_mod.make_film(ro.film_name, ro.film_params, self.filter_spec, opts)
        if one_tile:
            rows = max(1, self.tile_pixels // film.nx)
            film = dataclasses.replace(film, y1=min(film.y1, film.y0 + rows))
        to_world = ((ro.camera_to_world or Transform()) if frame.eye is None
                    else Transform.look_at(frame.eye, frame.look, frame.up))
        camera = make_camera(ro.camera_name, ro.camera_params, to_world, film.xres, film.yres)
        sampler = make_sampler(ro.sampler_name, ro.sampler_params, opts)
        return render_sampler(self.scene, ro, film, camera, sampler, opts)

    def close(self):
        """Frees the scene, so that the reference runs on an empty card."""
        self.scene = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
