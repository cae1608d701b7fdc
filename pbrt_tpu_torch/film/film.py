"""Image film: filtered sample accumulation.

Port of pbrt_tpu/film/film.py (reference film/image.cpp ImageFilm +
filters/*.cpp). Each sample is deposited into its filter footprint,
one footprint offset at a time, with `index_put_(accumulate=True)`.
On CUDA that is a float atomic add, so the sums depend on the order in
which samples land: pixel values may differ from run to run in the
last bits (CHANGES.md states the tolerance this costs).

Accumulators are XYZ + weightSum per pixel, the reference's Pixel
layout (film/image.h:71-82), plus the unfiltered XYZ splat sums of the
metropolis renderer, added at write time with a scale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import info, warning
from pbrt_tpu_torch.scene.paramset import ParamSet

F_BOX, F_TRIANGLE, F_GAUSSIAN, F_MITCHELL, F_SINC = range(5)


@dataclass
class Film:
    xres: int
    yres: int
    # pixel bounds from crop window (reference film/image.cpp ctor)
    x0: int
    y0: int
    x1: int
    y1: int
    filter_kind: int
    fr_x: float
    fr_y: float
    fparam: Tuple[float, ...]  # (alpha) | (B, C) | (tau)
    filename: str = "pbrt.exr"

    @property
    def nx(self):
        return self.x1 - self.x0

    @property
    def ny(self):
        return self.y1 - self.y0


class FilmState(NamedTuple):
    xyz: torch.Tensor      # [ny, nx, 3]
    weight: torch.Tensor   # [ny, nx]
    splat: torch.Tensor    # [ny, nx, 3]


def make_filter(name: str, params: ParamSet):
    """reference filters/*.cpp:45-49 Create*Filter."""
    if name == "box":
        xw = params.find_one_float("xwidth", 0.5)
        yw = params.find_one_float("ywidth", 0.5)
        kind, fp = F_BOX, ()
    elif name == "triangle":
        xw = params.find_one_float("xwidth", 2.0)
        yw = params.find_one_float("ywidth", 2.0)
        kind, fp = F_TRIANGLE, ()
    elif name == "gaussian":
        xw = params.find_one_float("xwidth", 2.0)
        yw = params.find_one_float("ywidth", 2.0)
        kind, fp = F_GAUSSIAN, (params.find_one_float("alpha", 2.0),)
    elif name == "mitchell":
        xw = params.find_one_float("xwidth", 2.0)
        yw = params.find_one_float("ywidth", 2.0)
        kind, fp = F_MITCHELL, (
            params.find_one_float("B", 1.0 / 3.0),
            params.find_one_float("C", 1.0 / 3.0),
        )
    elif name == "sinc":
        xw = params.find_one_float("xwidth", 4.0)
        yw = params.find_one_float("ywidth", 4.0)
        kind, fp = F_SINC, (params.find_one_float("tau", 3.0),)
    else:
        warning(f'Filter "{name}" unknown; using box.')
        return make_filter("box", params)
    params.report_unused(f'in filter "{name}"')
    return kind, xw, yw, fp


def make_film(name: str, params: ParamSet, filter_spec, options: Optional[dict] = None) -> Film:
    """reference film/image.cpp:224-267 CreateImageFilm."""
    options = options or {}
    if name != "image":
        warning(f'Film "{name}" unknown; using "image".')
    xres = params.find_one_int("xresolution", 640)
    yres = params.find_one_int("yresolution", 480)
    if options.get("quick"):
        xres = max(1, xres // 4)
        yres = max(1, yres // 4)
    crop = params.find_float("cropwindow")
    cw = [0.0, 1.0, 0.0, 1.0]
    if crop is not None and len(crop) == 4:
        cw = [
            min(crop[0], crop[1]), max(crop[0], crop[1]),
            min(crop[2], crop[3]), max(crop[2], crop[3]),
        ]
    x0 = int(math.ceil(xres * cw[0]))
    x1 = max(x0 + 1, int(math.ceil(xres * cw[1])))
    y0 = int(math.ceil(yres * cw[2]))
    y1 = max(y0 + 1, int(math.ceil(yres * cw[3])))
    filename = params.find_one_string("filename", "")
    if options.get("imageFile"):
        filename = options["imageFile"]
    if not filename:
        filename = "pbrt.exr"
    params.report_unused('in film "image"')
    kind, xw, yw, fp = filter_spec
    return Film(xres=xres, yres=yres, x0=x0, y0=y0, x1=x1, y1=y1,
                filter_kind=kind, fr_x=xw, fr_y=yw, fparam=fp, filename=filename)


def init_state(film: Film, device) -> FilmState:
    return FilmState(xyz=torch.zeros((film.ny, film.nx, 3), device=device),
                     weight=torch.zeros((film.ny, film.nx), device=device),
                     splat=torch.zeros((film.ny, film.nx, 3), device=device))


def _filter_eval(film: Film, dx, dy):
    """Filter weight at offset (dx, dy) from the sample center."""
    k = film.filter_kind
    zero = torch.zeros((), device=dx.device)
    ax, ay = torch.abs(dx), torch.abs(dy)
    inside = (ax <= film.fr_x) & (ay <= film.fr_y)
    if k == F_BOX:
        w = torch.ones_like(dx)
    elif k == F_TRIANGLE:
        w = torch.clamp(film.fr_x - ax, min=0.0) * torch.clamp(film.fr_y - ay, min=0.0)
    elif k == F_GAUSSIAN:
        alpha = film.fparam[0]
        ex = torch.exp(-alpha * dx * dx) - math.exp(-alpha * film.fr_x * film.fr_x)
        ey = torch.exp(-alpha * dy * dy) - math.exp(-alpha * film.fr_y * film.fr_y)
        w = torch.clamp(ex, min=0.0) * torch.clamp(ey, min=0.0)
    elif k == F_MITCHELL:
        B, C = film.fparam

        def m1d(x):
            x = torch.abs(2.0 * x)
            inner = (
                (12.0 - 9.0 * B - 6.0 * C) * x ** 3
                + (-18.0 + 12.0 * B + 6.0 * C) * x ** 2
                + (6.0 - 2.0 * B)
            ) * (1.0 / 6.0)
            outer = (
                (-B - 6.0 * C) * x ** 3 + (6.0 * B + 30.0 * C) * x ** 2
                + (-12.0 * B - 48.0 * C) * x + (8.0 * B + 24.0 * C)
            ) * (1.0 / 6.0)
            return torch.where(x > 1.0, outer, inner)

        w = m1d(dx / film.fr_x) * m1d(dy / film.fr_y)
    else:  # F_SINC (Lanczos windowed)
        tau = film.fparam[0]

        def sinc1d(x, width):
            x = torch.abs(x / width)
            xt = torch.clamp(x * tau, min=1e-6)
            lanczos = torch.sin(math.pi * xt) / (math.pi * xt)
            window = torch.sin(math.pi * x) / torch.clamp(math.pi * x, min=1e-6)
            val = lanczos * window
            return torch.where(x < 1e-5, torch.ones((), device=x.device),
                               torch.where(x > 1.0, zero, val))

        w = sinc1d(dx, film.fr_x) * sinc1d(dy, film.fr_y)
    return torch.where(inside, w, zero)


def add_samples(film: Film, state: FilmState, px, py, L_spec, ray_weight=None) -> FilmState:
    """Deposit spectra at continuous raster positions with filtering
    (reference film/image.cpp:77-133 AddSample, filter evaluated exactly).
    px/py: [N] raster coords; L_spec: [N, S]. Accumulates in place."""
    xyz = spec.to_xyz(L_spec)  # [N, 3]
    if ray_weight is not None:
        xyz = xyz * ray_weight[..., None]
    # continuous -> discrete (pbrt: dimage = dsample - 0.5)
    dx = px - 0.5
    dy = py - 0.5
    rx = max(1, int(math.ceil(film.fr_x - 0.5)) + 1)
    ry = max(1, int(math.ceil(film.fr_y - 0.5)) + 1)
    x_base = torch.floor(dx).to(torch.int64)
    y_base = torch.floor(dy).to(torch.int64)
    zero = torch.zeros((), device=px.device)
    for oy in range(-ry + 1, ry + 1):
        for ox in range(-rx + 1, rx + 1):
            xi = x_base + ox
            yi = y_base + oy
            w = _filter_eval(film, xi - dx, yi - dy)
            xg = xi - film.x0
            yg = yi - film.y0
            valid = (xg >= 0) & (xg < film.nx) & (yg >= 0) & (yg < film.ny)
            w = torch.where(valid, w, zero)
            xg = torch.clamp(xg, 0, film.nx - 1)
            yg = torch.clamp(yg, 0, film.ny - 1)
            state.xyz.index_put_((yg, xg), w[..., None] * xyz, accumulate=True)
            state.weight.index_put_((yg, xg), w, accumulate=True)
    return state


def splat(film: Film, state: FilmState, px, py, L_spec) -> FilmState:
    """Unfiltered splat (reference film/image.cpp:140-153, used by MLT):
    each sample's XYZ into the pixel under it; samples outside the
    film's pixel bounds add nothing. Accumulates in place."""
    xyz = spec.to_xyz(L_spec)
    xi = torch.clamp(torch.floor(px).to(torch.int64) - film.x0, 0, film.nx - 1)
    yi = torch.clamp(torch.floor(py).to(torch.int64) - film.y0, 0, film.ny - 1)
    inb = (px >= film.x0) & (px < film.x1) & (py >= film.y0) & (py < film.y1)
    xyz = torch.where(inb[..., None], xyz, torch.zeros((), device=xyz.device))
    state.splat.index_put_((yi, xi), xyz, accumulate=True)
    return state


def _to_host(a) -> np.ndarray:
    """One accumulator on the host: a copy that waits on the card."""
    with probes.scope("sync/film"):
        return a.cpu().numpy()


def to_rgb(film: Film, state: FilmState, splat_scale: float = 1.0) -> np.ndarray:
    """Resolve accumulators to RGB (reference film/image.cpp:155-218
    WriteImage: XYZ->RGB, weight normalize, then the splats times
    splat_scale added)."""
    xyz, wsum, splat_xyz = (_to_host(a).astype(np.float64)
                            for a in (state.xyz, state.weight, state.splat))
    rgb = xyz @ np.asarray(spec.XYZ_TO_RGB).T
    rgb = np.where(wsum[..., None] > 0.0, rgb / np.maximum(wsum[..., None], 1e-20), 0.0)
    rgb = np.maximum(rgb, 0.0)
    rgb = rgb + splat_scale * (splat_xyz @ np.asarray(spec.XYZ_TO_RGB).T)
    return rgb.astype(np.float32)


def write_image(film: Film, state: FilmState, splat_scale: float = 1.0) -> np.ndarray:
    from pbrt_tpu_torch.io.image import write_image as io_write

    rgb = to_rgb(film, state, splat_scale)
    io_write(film.filename, rgb)
    info(f"Wrote image {film.filename} ({film.nx}x{film.ny})")
    return rgb
