"""Film deposit (all five filters) and the perspective camera against
the JAX package, on the same seeded NumPy inputs.

Tolerances: rtol 1e-4 / atol 1e-6. The filters evaluate exp and sin in
different libraries (XLA vs ATen), which differ by a few ulp, and a
pixel's sum of filtered deposits is taken in the order each library's
scatter-add picks. The camera's ray directions go through a 4x4
transform, a normalize and (thin lens) sin/cos: a few ulp again.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import cameras as jc
from pbrt_tpu.core.transform import Transform as JTransform
from pbrt_tpu.film import film as jf
from pbrt_tpu.scene.paramset import ParamSet as JParamSet
from pbrt_tpu_torch.cameras import cameras as tc
from pbrt_tpu_torch.core.transform import Transform as TTransform
from pbrt_tpu_torch.film import film as tf
from pbrt_tpu_torch.scene.paramset import ParamSet as TParamSet

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

S = 30
N = 4096


def _params(cls, items):
    ps = cls()
    for decl, name, values in items:
        ps.add(decl, name, values)
    return ps


def _close(got, ref, name):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-4, atol=1e-6,
                               err_msg=name)


@pytest.mark.parametrize("pixel_filter", ["box", "triangle", "gaussian", "mitchell", "sinc"])
def test_film_add_samples_matches_jax(pixel_filter):
    """Filtered deposit into a cropped 24x20 film, samples scattered over
    and beyond the crop window, then the XYZ -> RGB resolve."""
    film_items = [("integer", "xresolution", [24]), ("integer", "yresolution", [20]),
                  ("float", "cropwindow", [0.1, 0.9, 0.2, 1.0])]
    films = []
    for mod, cls in ((jf, JParamSet), (tf, TParamSet)):
        spec = mod.make_filter(pixel_filter, cls())
        films.append(mod.make_film("image", _params(cls, film_items), spec))
    jfilm, tfilm = films
    assert (tfilm.x0, tfilm.x1, tfilm.y0, tfilm.y1) == (jfilm.x0, jfilm.x1, jfilm.y0, jfilm.y1)

    rng = np.random.RandomState(5)
    px = rng.uniform(-2, 26, N).astype(np.float32)
    py = rng.uniform(-2, 22, N).astype(np.float32)
    L = rng.uniform(0, 2, (N, S)).astype(np.float32)
    rw = rng.uniform(0.5, 1.0, N).astype(np.float32)

    js = jf.add_samples(jfilm, jf.init_state(jfilm), jnp.asarray(px), jnp.asarray(py),
                        jnp.asarray(L), jnp.asarray(rw))
    ts = tf.add_samples(tfilm, tf.init_state(tfilm, "cpu"), torch.as_tensor(px),
                        torch.as_tensor(py), torch.as_tensor(L), torch.as_tensor(rw))
    _close(ts.weight, js.weight, "weight")
    _close(ts.xyz, js.xyz, "xyz")
    rgb = tf.to_rgb(tfilm, ts)
    assert rgb.shape == (tfilm.ny, tfilm.nx, 3) and rgb.mean() > 0
    _close(rgb, jf.to_rgb(jfilm, js), "rgb")


@pytest.mark.parametrize("lens", [False, True])
def test_perspective_camera_matches_jax(lens):
    """generate_rays of the perspective camera, pinhole and thin lens,
    with a wide film, a non-default fov and a shutter interval."""
    items = [("float", "fov", [38.0]), ("float", "shutteropen", [0.25]),
             ("float", "shutterclose", [0.75])]
    if lens:
        items += [("float", "lensradius", [0.08]), ("float", "focaldistance", [4.5])]
    look = ([0.5, 1.5, -5.0], [0.0, 0.3, 0.0], [0.0, 1.0, 0.0])
    jcam = jc.make_camera("perspective", _params(JParamSet, items), JTransform.look_at(*look),
                          48, 32)
    tcam = tc.make_camera("perspective", _params(TParamSet, items), TTransform.look_at(*look),
                          48, 32)
    np.testing.assert_array_equal(tcam.raster_to_camera, jcam.raster_to_camera)
    np.testing.assert_array_equal(tcam.cam_to_world, jcam.cam_to_world)

    rng = np.random.RandomState(9)
    px = rng.uniform(0, 48, N).astype(np.float32)
    py = rng.uniform(0, 32, N).astype(np.float32)
    u = rng.uniform(0, 1, (3, N)).astype(np.float32)
    jray, jw = jcam.generate_rays(jnp.asarray(px), jnp.asarray(py), *map(jnp.asarray, u))
    tray, tw = tcam.generate_rays(torch.as_tensor(px), torch.as_tensor(py),
                                  *map(torch.as_tensor, u))
    for field in ("o", "d", "tmin", "tmax", "time"):
        _close(getattr(tray, field), getattr(jray, field), field)
    _close(tw, jw, "weight")
