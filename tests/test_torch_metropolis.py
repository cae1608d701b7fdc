"""Metropolis light transport of the port against the JAX package, on
the same inputs: the random numbers, the film's splats, and the
bidirectional path contribution; and the port's MLT image against its
own sampler renderer (the statistical test of tests/test_integrators.py).

Tolerances: the threefry draws are bit for bit jax.random's (the mode
of the installed JAX, jax_threefry_partitionable = True); choice's
indices may differ only where r falls within 1e-6 relative of the CDF
entry (none differ: the running sum is XLA's to the bit). Splats and their RGB resolve:
rtol 1e-6 (a pixel's sum is taken in each library's scatter order).
path_l_psamples on identical primary samples through identical bridged
light-pick tables: px, py identical, L within 1e-5 relative of the
largest contribution (float rounding of XLA vs ATen; observed 4e-7).
The whole-render comparison is in test_torch_metropolis_render.py.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import _parse, _render, scene_text  # noqa: E402

from pbrt_tpu.cameras.cameras import make_camera as j_make_camera  # noqa: E402
from pbrt_tpu.core.transform import Transform as JTransform  # noqa: E402
from pbrt_tpu.film import film as j_film  # noqa: E402
from pbrt_tpu.integrators import bidir as j_bidir  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu.scene.compile import compile_scene as j_compile  # noqa: E402
from pbrt_tpu_torch import bridge  # noqa: E402
from pbrt_tpu_torch.cameras.cameras import make_camera as t_make_camera  # noqa: E402
from pbrt_tpu_torch.core import threefry  # noqa: E402
from pbrt_tpu_torch.core.transform import Transform as TTransform  # noqa: E402
from pbrt_tpu_torch.film import film as t_film  # noqa: E402
from pbrt_tpu_torch.integrators import bidir as t_bidir  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def test_jax_random_mode():
    assert jax.config.jax_threefry_partitionable, (
        "core/threefry.py copies jax.random's threefry2x32 with "
        "jax_threefry_partitionable = True; this JAX runs the other mode")


@pytest.mark.parametrize("seed", [0, 1])
def test_threefry_matches_jax_random(seed):
    """PRNGKey, split into 2 and 4, fold_in(k, 7) and float32 uniform at
    (4096,) and (4096, D) (D of maxdepth 5, bidirectional): bit for bit."""
    D = t_bidir.n_psample_dims(5, True)
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    assert tuple(np.asarray(jk).tolist()) == tk
    for n in (2, 4):
        assert [tuple(r) for r in np.asarray(jax.random.split(jk, n)).tolist()] == \
            [tuple(k) for k in threefry.split(tk, n)]
    assert tuple(np.asarray(jax.random.fold_in(jk, 7)).tolist()) == threefry.fold_in(tk, 7)
    k2 = jax.random.split(jk)[1]
    for shape in ((4096,), (4096, D)):
        ref = np.asarray(jax.random.uniform(k2, shape))
        got = threefry.uniform(threefry.split(tk)[1], shape, "cpu").numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_choice_matches_jax_random():
    """jax.random.choice with p over a bootstrap-like distribution of
    100,000 luminances (70% zero): an index may differ only where r lies
    within 1e-6 relative of the CDF entry (a float32 running sum
    rounding the other way could move such a draw); none differ here,
    as the running sum is XLA's to the bit."""
    rng = np.random.RandomState(3)
    ys = (rng.exponential(size=100_000) * (rng.rand(100_000) < 0.3)).astype(np.float32)
    probs = ys.astype(np.float64)
    probs /= probs.sum()
    p32 = probs.astype(np.float32)
    key = jax.random.split(jax.random.PRNGKey(0))[1]
    ref = np.asarray(jax.random.choice(key, len(ys), (4096,), p=jnp.asarray(p32)))
    tk = threefry.split(threefry.prng_key(0))[1]
    got = threefry.choice(tk, len(ys), (4096,), torch.as_tensor(p32)).numpy()
    cdf = np.asarray(jnp.cumsum(jnp.asarray(p32)))
    np.testing.assert_array_equal(threefry.cumsum_f32(torch.as_tensor(p32)).numpy(), cdf)
    r = cdf[-1] * (1.0 - threefry.uniform(tk, (4096,), "cpu").numpy())
    differ = got != ref
    assert np.all(np.abs(r[differ] - cdf[ref[differ]]) <= 1e-6 * np.abs(r[differ]))
    assert int(differ.sum()) == 0
    assert len(np.unique(got)) > 1000


def test_film_splat_matches_jax():
    """Unfiltered splats into a cropped film, samples inside and outside
    its pixel bounds, then to_rgb with a splat scale over a filtered
    deposit."""
    from pbrt_tpu.scene.paramset import ParamSet as JParamSet
    from pbrt_tpu_torch.scene.paramset import ParamSet

    films = []
    for mod, cls in ((j_film, JParamSet), (t_film, ParamSet)):
        ps = cls()
        ps.add("integer", "xresolution", [24])
        ps.add("integer", "yresolution", [20])
        ps.add("float", "cropwindow", [0.1, 0.9, 0.2, 1.0])
        films.append(mod.make_film("image", ps, mod.make_filter("box", cls())))
    jf, tf = films
    rng = np.random.RandomState(4)
    n = 4096
    px = rng.uniform(-2, 26, n).astype(np.float32)
    py = rng.uniform(-2, 22, n).astype(np.float32)
    L = rng.uniform(0, 2, (n, 30)).astype(np.float32)
    js = j_film.add_samples(jf, j_film.init_state(jf), jnp.asarray(px[:512]),
                            jnp.asarray(py[:512]), jnp.asarray(L[:512]))
    js = j_film.splat(jf, js, jnp.asarray(px), jnp.asarray(py), jnp.asarray(L))
    ts = t_film.init_state(tf, "cpu")
    t_film.add_samples(tf, ts, torch.as_tensor(px[:512]), torch.as_tensor(py[:512]),
                       torch.as_tensor(L[:512]))
    t_film.splat(tf, ts, torch.as_tensor(px), torch.as_tensor(py), torch.as_tensor(L))
    np.testing.assert_allclose(ts.splat.numpy(), np.asarray(js.splat), rtol=1e-6, atol=1e-6)
    inside = (px >= tf.x0) & (px < tf.x1) & (py >= tf.y0) & (py < tf.y1)
    assert 0.3 < inside.mean() < 0.9
    for scale in (1.0, 0.37):
        np.testing.assert_allclose(t_film.to_rgb(tf, ts, scale), j_film.to_rgb(jf, js, scale),
                                   rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def mlt_scene(tmp_path_factory):
    """The slice scene (292 triangles: matte, plastic, mirror and glass
    spheres, a triangle area light, a point light) at 8 x 8, compiled by
    both packages; the port takes the JAX package's light-pick table
    (bridge.py), whose float32 running sum rounds apart from ATen's."""
    path = tmp_path_factory.mktemp("mlt") / "scene.pbrt"
    path.write_text(scene_text(res=8, spp=1, depth=3))
    jro, tro = _parse(j_api, j_parser, path), _parse(t_api, t_parser, path)
    js, ts = j_compile(jro), t_compile(tro, "cpu")
    ts.light_dist = bridge.from_arrays({f"light_dist.{f}": np.asarray(getattr(js.light_dist, f))
                                        for f in bridge.DIST_FIELDS}, "light_dist", "cpu")
    jf = j_film.make_film(jro.film_name, jro.film_params,
                          j_film.make_filter(jro.filter_name, jro.filter_params))
    tf = t_film.make_film(tro.film_name, tro.film_params,
                          t_film.make_filter(tro.filter_name, tro.filter_params))
    jc = j_make_camera(jro.camera_name, jro.camera_params, jro.camera_to_world or JTransform(),
                       jf.xres, jf.yres)
    tc = t_make_camera(tro.camera_name, tro.camera_params, tro.camera_to_world or TTransform(),
                       tf.xres, tf.yres)
    return (js, jc, jf), (ts, tc, tf)


@pytest.mark.parametrize("skip_direct", [True, False], ids=["skipdirect", "all"])
@pytest.mark.parametrize("bidirectional", [True, False], ids=["bidir", "unidir"])
def test_path_l_psamples_matches_jax(mlt_scene, bidirectional, skip_direct):
    """256 chains' seeded primary samples, maxdepth 3."""
    (js, jc, jf), (ts, tc, tf) = mlt_scene
    D = t_bidir.n_psample_dims(3, bidirectional)
    assert D == j_bidir.n_psample_dims(3, bidirectional)
    u = np.random.RandomState(5).rand(256, D).astype(np.float32)
    jpx, jpy, jL = (np.asarray(x) for x in j_bidir.path_l_psamples(
        js, jc, jf, jnp.asarray(u), 3, bidirectional=bidirectional, skip_direct=skip_direct))
    tpx, tpy, tL = (x.numpy() for x in t_bidir.path_l_psamples(
        ts, tc, tf, torch.as_tensor(u), 3, bidirectional=bidirectional, skip_direct=skip_direct))
    np.testing.assert_array_equal(tpx, jpx)
    np.testing.assert_array_equal(tpy, jpy)
    assert (jL.sum(-1) > 0).sum() >= 5
    np.testing.assert_allclose(tL, jL, rtol=1e-5, atol=1e-5 * np.abs(jL).max())


WORLD = """WorldBegin
LightSource "point" "point from" [0 3 -2] "rgb I" [25 25 25]
AttributeBegin
  Material "matte" "rgb Kd" [.6 .6 .6]
  Shape "sphere" "float radius" [0.8]
AttributeEnd
AttributeBegin
  Translate 0 -1 0
  Rotate -90 1 0 0
  Material "matte" "rgb Kd" [.5 .5 .5]
  Shape "disk" "float radius" [5]
AttributeEnd
WorldEnd
"""


def test_metropolis_matches_sampler_statistically(tmp_path):
    """The port's version of tests/test_integrators.py's test: the same
    scene through the sampler renderer (8 spp) and through metropolis
    (16 mutations a pixel, 8,192 bootstrap paths, the direct pass
    separate): image means within 15%, 6 x 6 block means within 0.35
    relative on average (reference metropolis.cpp:514-521 is tuned so
    the splat-scaled mean matches the sampler's estimate)."""
    head = ('Film "image" "integer xresolution" [24] "integer yresolution" [24]\n'
            'LookAt 0 1 -3  0 0 0  0 1 0\nCamera "perspective" "float fov" [50]\n')

    def run(lines, name):
        path = tmp_path / f"{name}.pbrt"
        path.write_text(head + lines + WORLD)
        return _render(t_api, t_parser, path, {"tile_samples": 24 * 24 * 8})

    ref = run('Sampler "lowdiscrepancy" "integer pixelsamples" [8]\n', "sampler")
    mlt = run('Renderer "metropolis" "integer samplesperpixel" [16]\n'
              '  "integer bootstrapsamples" [8192] "bool dodirectseparately" ["true"]\n', "mlt")
    assert ref.shape == mlt.shape and np.all(np.isfinite(mlt))
    level = max(float(ref.mean()), 1e-6)
    assert abs(float(mlt.mean()) - level) / level < 0.15, (mlt.mean(), ref.mean())
    rb = ref.reshape(4, 6, 4, 6, -1).mean(axis=(1, 3, 4))
    mb = mlt.reshape(4, 6, 4, 6, -1).mean(axis=(1, 3, 4))
    rel = np.abs(mb - rb) / np.maximum(rb, 0.1 * level)
    assert float(rel.mean()) < 0.35, rel
