"""The port's diffuseprt and glossyprt integrators and the lights' SH
projection (pbrt_tpu_torch/integrators/extra.py) against the JAX
package's.

Renders: tests/test_integrators.py's BASE scene with WORLD's sphere and
disk under a distant light (the point light of WORLD projects to
nothing), 16 x 16, 1 spp, seed 0, in one tile of exactly the image's
samples; limits as in tests/test_torch_extra_integrators.py. The SH
projection of a distant light and of an environment map: within 1e-5 of
the largest coefficient.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.integrators import extra as j_extra
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.integrators import extra as t_extra
from pbrt_tpu_torch.io.image import write_image
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from test_integrators import BASE, WORLD
from test_torch_extra_integrators import assert_same_image, render
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

DISTANT = WORLD.replace('LightSource "point" "point from" [0 3 -2] "rgb I" [25 25 25]',
                        'LightSource "distant" "point from" [1 3 -2] "point to" [0 0 0] '
                        '"rgb L" [3 3 3]')
GLOSSY = DISTANT.replace('Material "matte" "rgb Kd" [.6 .6 .6]',
                         'Material "plastic" "rgb Kd" [.3 .3 .3] "rgb Ks" [.5 .5 .5]')
CASES = {
    "diffuseprt": 'SurfaceIntegrator "diffuseprt" "integer lmax" [2] "integer nsamples" [1024]\n'
                  + DISTANT,
    "glossyprt": 'SurfaceIntegrator "glossyprt" "integer lmax" [2]\n' + GLOSSY,
}


@pytest.mark.parametrize("name", list(CASES))
def test_prt_integrator_matches_jax(tmp_path, name):
    path = tmp_path / "scene.pbrt"
    path.write_text(BASE + CASES[name])
    assert_same_image(render(t_api, t_parser, path), render(j_api, j_parser, path))


def test_light_sh_matches_jax_and_is_cached_per_scene(tmp_path):
    """A distant light and an infinite light with a seeded map, projected
    to lmax 4 by both packages; the port keeps one projection per
    compiled scene object, so a second scene gets its own."""
    env = tmp_path / "sky.pfm"
    write_image(str(env), (np.random.RandomState(2).rand(16, 32, 3) + 0.2).astype(np.float32))
    lights = DISTANT.replace("WorldBegin\n", 'WorldBegin\nAttributeBegin\nRotate -90 1 0 0\n'
                             f'LightSource "infinite" "string mapname" "{env}"\nAttributeEnd\n')
    path = tmp_path / "scene.pbrt"
    path.write_text(BASE + lights)
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    j_extra._LIGHT_SH_CACHE.clear()
    ref = np.asarray(j_extra._light_sh(js, 4))
    got = t_extra._light_sh(ts, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert t_extra._light_sh(ts, 4) is got   # cached on the scene
    path.write_text(BASE + DISTANT)
    other = t_compile(_parse(t_api, t_parser, path), "cpu")
    assert not torch.equal(t_extra._light_sh(other, 4), got)
