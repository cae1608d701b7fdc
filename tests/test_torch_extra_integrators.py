"""The port's igi and irradiancecache integrators
(pbrt_tpu_torch/integrators/extra.py) against the JAX package's
(diffuseprt and glossyprt: tests/test_torch_prt.py; dipolesubsurface
and useprobes: tests/test_torch_probes.py).

Renders: tests/test_integrators.py's BASE / WORLD scene (a sphere on a
disk, 16 x 16, 1 spp; not --quick, which would cut the film to 4 x 4),
seed 0, through both packages in one tile of exactly the image's
samples. Limits: the whole-slice limits of tests/test_torch_slice.py,
image mean within 0.5% and at least 99% of pixels within 1e-3 relative.
The JAX package's light-SH cache is keyed by id(scene) (ROADMAP R20), so
it is cleared before each JAX render (render() here serves the other
files too).

igi's VPL sets and set pick: tests/test_torch_vpls.py.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.integrators import extra as j_extra
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from test_integrators import BASE, WORLD

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

CASES = {
    "igi": 'SurfaceIntegrator "igi" "integer nlights" [8] "integer nsets" [2] '
           '"integer maxdepth" [3]\n' + WORLD,
    "irradiancecache": 'SurfaceIntegrator "irradiancecache" "integer nsamples" [512]\n' + WORLD,
}


def render(api, parser, path, tile_samples=16 * 16):
    """Both packages pad a short tile with copies of the last pixel's
    samples, which the film adds once a copy in float32 (ROADMAP R23),
    so the tile is the image's sample count."""
    opts = {"quiet": True, "write": False, "tile_samples": tile_samples}
    if api is t_api:
        opts.update(device="cpu")
    else:
        j_extra._LIGHT_SH_CACHE.clear()
    api.pbrt_init(opts)
    try:
        parser.parse_file(str(path))
        return api._state.output
    finally:
        api._state.__init__()


def assert_same_image(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


@pytest.mark.parametrize("name", list(CASES))
def test_integrator_matches_jax(tmp_path, name):
    path = tmp_path / "scene.pbrt"
    path.write_text(BASE + CASES[name])
    assert_same_image(render(t_api, t_parser, path), render(j_api, j_parser, path))
