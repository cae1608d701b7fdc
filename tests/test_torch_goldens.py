"""The reference-binary goldens rendered by the port on the CPU.

`matte`, `meshdl`, `mesh`, `smoke`, `vol`, `disp`, `irr` and `dprt`
(quadrics, directlighting, path, dispersive glass, single scattering in
a homogeneous volume, photon mapping of a dispersive caustic, the
cache-free irradiance cache under a disk area light, diffuse PRT under a
distant light) are rendered at their authored size and sample count and
held to the bounds of tests/test_reference_golden.py against the
reference binary's images.

Then each but `disp` (tests/test_torch_photon_*.py hold the photon
integrators against the JAX package) is rendered by the port and by the JAX package at the same
seed on a centred crop of at most 24 x 24 pixels at 4 spp, and so are
`meshdl` under whitted and under directlighting "strategy" "one", and an
ambientocclusion render at 16 x 16. The random streams are bit-identical,
so the images differ only by float rounding: image mean within 0.5% and
at least 99% of pixels within 1e-3 relative (the whole-slice limits of
tests/test_torch_slice.py). To keep the JAX package's CPU compile short
the crops cut maxdepth: to 1 for matte and vol (every surface is
diffuse, so directlighting follows no ray past depth 0 and the image is
the authored one), to 2 for meshdl and mesh, and to 3 for smoke (the
floor seen through the glass sphere). `irr` and `dprt` take no maxdepth
(their integrators trace one camera hit); their crops keep the authored
integrator, dprt's with 1024 transfer samples (16 rays a hit, against the
authored 64) to keep the JAX package's compile short.
"""
import os
import re

import numpy as np
import pytest
import torch

from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu_torch.io.image import read_image
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from test_reference_golden import CASES, GOLDEN_DIR

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

PORTED = ("matte", "meshdl", "mesh", "smoke", "vol", "disp", "irr", "dprt")
CROPPED = ("matte", "meshdl", "mesh", "smoke", "vol", "irr", "dprt")
BOUNDS = {name: (mean_rtol, pix) for name, mean_rtol, pix in CASES if name in PORTED}
CROP_DEPTH = {"matte": 1, "vol": 1, "meshdl": 2, "mesh": 2, "smoke": 3}
CROP_INTEGRATOR = {"dprt": 'SurfaceIntegrator "diffuseprt" "integer lmax" [4] '
                           '"integer nsamples" [1024]'}
CROP = (0.3125, 0.6875, 0.3125, 0.6875)


def render(api, parser, path):
    opts = {"quiet": True, "write": False}
    if api is t_api:
        opts.update(device="cpu")
    else:   # the JAX package's light-SH cache is keyed by id(scene) (ROADMAP R20)
        from pbrt_tpu.integrators import extra

        extra._LIGHT_SH_CACHE.clear()
    api.pbrt_init(opts)
    try:
        parser.parse_file(str(path))
        return np.asarray(api._state.output)
    finally:
        api._state.__init__()


def golden_text(name, crop=None, spp=None, depth=None, integrator=None, res=None):
    """The golden's scene file, optionally cropped, with another sample
    count, maxdepth, surface integrator line or resolution."""
    with open(os.path.join(GOLDEN_DIR, f"{name}.pbrt")) as f:
        s = f.read()
    if "SurfaceIntegrator" not in s:   # the default, written out so it can be edited
        s = s.replace("WorldBegin", 'SurfaceIntegrator "directlighting"\nWorldBegin', 1)
    if integrator is not None:
        s = re.sub(r"SurfaceIntegrator[^\n]*", integrator, s)
    if depth is not None:
        s = re.sub(r'(SurfaceIntegrator "\w+")[^\n]*', rf'\1 "integer maxdepth" [{depth}]', s)
    if res is not None:
        s = re.sub(r'"integer (x|y)resolution" \[\d+\]', rf'"integer \1resolution" [{res}]', s)
    if crop is not None:
        s = re.sub(r'(Film "image"[^\n]*)', r'\1 "float cropwindow" [%g %g %g %g]' % crop, s)
    if spp is not None:
        s = re.sub(r'"integer pixelsamples" \[\d+\]', f'"integer pixelsamples" [{spp}]', s)
    return s


@pytest.mark.parametrize("name", PORTED)
def test_port_matches_reference_binary(name):
    ref = np.asarray(read_image(os.path.join(GOLDEN_DIR, f"ref_{name}.pfm")))
    ours = render(t_api, t_parser, os.path.join(GOLDEN_DIR, f"{name}.pbrt"))
    assert ours.shape == ref.shape
    assert np.all(np.isfinite(ours))
    mean_rtol, pix_bound = BOUNDS[name]
    level = max(float(ref.mean()), 1e-6)
    assert abs(float(ours.mean()) - ref.mean()) / level < mean_rtol, (ours.mean(), ref.mean())
    assert float(np.abs(ours - ref).mean()) / level < pix_bound


def assert_same_render(tmp_path, text):
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    ref = render(j_api, j_parser, path)
    got = render(t_api, t_parser, path)
    assert got.shape == ref.shape and got.shape[0] * got.shape[1] <= 24 * 24
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


@pytest.mark.parametrize("name", CROPPED)
def test_port_matches_jax_on_crop(tmp_path, name):
    assert_same_render(tmp_path, golden_text(name, crop=CROP, spp=4, depth=CROP_DEPTH.get(name),
                                             integrator=CROP_INTEGRATOR.get(name)))


@pytest.mark.parametrize("integrator", ['SurfaceIntegrator "whitted"',
                                        'SurfaceIntegrator "directlighting" '
                                        '"string strategy" "one"'])
def test_meshdl_integrators_match_jax_on_crop(tmp_path, integrator):
    assert_same_render(tmp_path, golden_text("meshdl", crop=CROP, spp=4, depth=2,
                                             integrator=integrator))


def test_ambient_occlusion_matches_jax(tmp_path):
    integrator = ('SurfaceIntegrator "ambientocclusion" "integer nsamples" [4] '
                  '"float maxdist" [3]')
    assert_same_render(tmp_path, golden_text("meshdl", spp=4, integrator=integrator, res=16))
