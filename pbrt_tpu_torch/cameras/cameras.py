"""Perspective camera: batched ray generation.

Port of the perspective branch of pbrt_tpu/cameras/cameras.py
(reference cameras/perspective.cpp). Camera space looks down +z,
raster (0,0) is the upper-left film corner, the screen window defaults
to [-1,1] on the short axis. The other projective cameras are not yet
ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core.error import PbrtError, warning
from pbrt_tpu_torch.core.geometry import Ray, normalize
from pbrt_tpu_torch.core.sampling import concentric_sample_disk
from pbrt_tpu_torch.core.transform import Transform, xform_point_affine, xform_vector
from pbrt_tpu_torch.scene.paramset import ParamSet

CAM_PERSPECTIVE = 0


@dataclass
class Camera:
    """Host camera record; generate_rays runs on the samples' device."""

    kind: int
    cam_to_world: np.ndarray      # [4, 4]
    raster_to_camera: np.ndarray  # [4, 4]
    lens_radius: float = 0.0
    focal_distance: float = 1e30
    shutter_open: float = 0.0
    shutter_close: float = 1.0
    width: int = 0
    height: int = 0

    def generate_rays(self, px, py, u_lens1, u_lens2, u_time) -> Tuple[Ray, torch.Tensor]:
        """CameraSample batch -> (Ray [N], weight [N]) (reference
        cameras/perspective.cpp:60-100 GenerateRay)."""
        n = px.shape[0]
        dev = px.device
        r2c = torch.as_tensor(self.raster_to_camera, dtype=torch.float32, device=dev)
        c2w = torch.as_tensor(self.cam_to_world, dtype=torch.float32, device=dev)
        p_ras = torch.stack([px, py, torch.zeros_like(px)], -1)
        time = self.shutter_open + u_time * (self.shutter_close - self.shutter_open)

        p_cam = xform_point_affine(r2c[None], p_ras)
        o = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        d = normalize(p_cam)
        if self.lens_radius > 0.0:
            lx, ly = concentric_sample_disk(u_lens1, u_lens2)
            lx, ly = lx * self.lens_radius, ly * self.lens_radius
            ft = self.focal_distance / torch.clamp(d[..., 2], min=1e-9)
            p_focus = d * ft[..., None]
            o = torch.stack([lx, ly, torch.zeros_like(lx)], -1)
            d = normalize(p_focus - o)

        o_w = xform_point_affine(c2w[None], o)
        d_w = xform_vector(c2w[None], d)
        ray = Ray(o=o_w, d=d_w, tmin=torch.zeros((n,), device=dev),
                  tmax=torch.full((n,), float("inf"), device=dev), time=time)
        return ray, torch.ones((n,), device=dev)


def _screen_window(params: ParamSet, aspect: float):
    if aspect > 1.0:
        screen = [-aspect, aspect, -1.0, 1.0]
    else:
        screen = [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]
    sw = params.find_float("screenwindow")
    if sw is not None and len(sw) == 4:
        screen = [float(x) for x in sw]
    return screen


def make_camera(name: str, params: ParamSet, cam_to_world: Transform,
                xres: int, yres: int, shutter_open: float = 0.0,
                shutter_close: float = 1.0) -> Camera:
    """reference core/api.cpp:606-629 MakeCamera + CreatePerspectiveCamera."""
    if name in ("orthographic", "environment", "realistic"):
        raise PbrtError(f'not yet ported: camera "{name}"')
    if name != "perspective":
        warning(f'Camera "{name}" unknown; using "perspective".')
    aspect = float(xres) / float(yres)
    sopen = params.find_one_float("shutteropen", shutter_open)
    sclose = params.find_one_float("shutterclose", shutter_close)
    lensradius = params.find_one_float("lensradius", 0.0)
    focaldistance = params.find_one_float("focaldistance", 1e30)
    fov = params.find_one_float("fov", 90.0)
    halffov = params.find_one_float("halffov", -1.0)
    if halffov > 0.0:
        fov = 2.0 * halffov
    x0, x1, y0, y1 = _screen_window(params, aspect)
    cam_proj = Transform.perspective(fov, 1e-2, 1000.0)
    screen_to_raster = (
        Transform.scale(xres, yres, 1.0)
        * Transform.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
        * Transform.translate([-x0, -y1, 0.0])
    )
    raster_to_camera = cam_proj.inverse() * screen_to_raster.inverse()
    params.report_unused(f'in camera "{name}"')
    return Camera(
        kind=CAM_PERSPECTIVE,
        cam_to_world=cam_to_world.m.astype(np.float32),
        raster_to_camera=raster_to_camera.m.astype(np.float32),
        lens_radius=lensradius, focal_distance=focaldistance,
        shutter_open=sopen, shutter_close=sclose, width=xres, height=yres,
    )
