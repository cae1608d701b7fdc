"""The port's image-driven lights (environment maps, goniometric and
projection lights) against the JAX package's on the same inputs.

Compile parity of the light table and the EnvMaps (image, importance
tables), the light functions on bridged lights (env_le, sample_light,
light_pdf, sample_light_ray), the port's versions of the JAX package's
long-tail light tests, and one slice render through the entry point:
an exinfinite map, a goniometric and a projection light with the
halton sampler and the path integrator, against the JAX render.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import _parse, _render, scene_text  # noqa: E402

import pbrt_tpu.core.sampling as j_sampling  # noqa: E402
from pbrt_tpu.core import spectrum as j_spec  # noqa: E402
from pbrt_tpu.lights import lighting as j_light  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu.scene.compile import compile_scene as j_compile  # noqa: E402
from pbrt_tpu_torch import bridge  # noqa: E402
from pbrt_tpu_torch.core import spectrum as t_spec  # noqa: E402
from pbrt_tpu_torch.core.transform import Transform  # noqa: E402
from pbrt_tpu_torch.io.image import write_image  # noqa: E402
from pbrt_tpu_torch.lights import lighting as t_light  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile  # noqa: E402
from pbrt_tpu_torch.scene.paramset import ParamSet  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def light_images(d):
    """Seeded maps: a sky gradient with a bright sun and low noise
    (equirectangular), a goniometric and a projected image."""
    rng = np.random.RandomState(5)
    env = (np.linspace(0.2, 1.0, 32)[:, None, None] * np.ones((32, 64, 3))).astype(np.float32)
    env[4:8, 10:14] = 20.0
    env[20:, :, 2] = 0.0                      # zero texels: flat runs in the table
    env += rng.rand(*env.shape).astype(np.float32) * 0.05
    paths = {k: os.path.join(d, f"{k}.pfm") for k in ("env", "gonio", "proj")}
    write_image(paths["env"], env)
    write_image(paths["gonio"], (rng.rand(16, 32, 3) + 0.5).astype(np.float32))
    write_image(paths["proj"], rng.rand(12, 16, 3).astype(np.float32))
    return paths


def lights_text(paths):
    return ('AttributeBegin\nRotate -90 1 0 0\nLightSource "exinfinite" "rgb L" [1 1 1] '
            f'"string mapname" "{paths["env"]}"\nAttributeEnd\n'
            'AttributeBegin\nTranslate -1 3 0.5\nRotate 60 1 0 0\nLightSource "goniometric" '
            f'"rgb I" [8 8 8] "string mapname" "{paths["gonio"]}"\nAttributeEnd\n'
            'AttributeBegin\nTranslate 0.5 4 -0.5\nRotate 90 1 0 0\nLightSource "projection" '
            f'"rgb I" [30 30 30] "float fov" [60] "string mapname" "{paths["proj"]}"\n'
            'AttributeEnd\n')


def lit_scene_text(paths, res=16, spp=4, depth=2, sampler="halton"):
    s = scene_text(res=res, spp=spp, depth=depth, sampler=sampler)
    return s.replace('LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]\n',
                     lights_text(paths))


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    d = tmp_path_factory.mktemp("lights")
    paths = light_images(str(d))
    path = d / "scene.pbrt"
    path.write_text(lit_scene_text(paths))
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    return js, ts


def jax_light_arrays(js):
    out = {f"lights.{f}": np.asarray(getattr(js.lights, f)) for f in bridge.LIGHT_FIELDS}
    out.update(bridge.envs_to_arrays(js.envs, np.asarray(js.lights.kind)))
    out.update({f"light_dist.{f}": np.asarray(getattr(js.light_dist, f))
                for f in bridge.DIST_FIELDS})
    return out


def test_light_compile_parity(compiled):
    """Kinds, transforms, spectra, params, power and the EnvMaps' images
    equal the JAX compile's; the importance tables (a float32 cumsum in
    each package) and the power-weighted pick CDF within 1e-6 relative."""
    js, ts = compiled
    ref = jax_light_arrays(js)
    got = bridge.to_arrays("lights", ts.lights)
    got.update(bridge.to_arrays("light_dist", ts.light_dist))
    assert set(got) == set(ref)
    assert int(ref["envs.count"]) == 3
    assert sorted(int(ref[f"env{i}.kind"]) for i in range(3)) == [
        t_light.L_GONIO, t_light.L_PROJECTION, t_light.L_INFINITE]
    for key in sorted(ref):
        if key.startswith("light_dist.") or "_cdf" in key or "func" in key:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], ref[key].astype(got[key].dtype), err_msg=key)


def _close(got, ref, what, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=rtol * max(1e-6, float(np.abs(np.asarray(ref)).max())),
                               err_msg=what)


def test_light_functions_match_jax(compiled):
    """On the JAX package's lights (bridged): env_le, sample_light,
    light_pdf and sample_light_ray for every light, within 1e-5
    relative (absolute slack of 1e-5 of the largest value)."""
    js, _ = compiled
    lights = bridge.from_arrays(jax_light_arrays(js), "lights", "cpu")
    rng = np.random.RandomState(6)
    n = 3000
    L = int(js.lights.kind.shape[0])
    idx = rng.randint(0, L, n).astype(np.int32)
    p = (rng.rand(n, 3) * [4, 2, 4] - [2, 0, 2]).astype(np.float32)
    u = rng.rand(4, n).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    wi = d / np.linalg.norm(d, axis=1, keepdims=True)

    _close(t_light.env_le(lights, torch.as_tensor(d)), j_light.env_le(js.lights, js.envs,
                                                                      jnp.asarray(d)), "env_le")
    ref = j_light.sample_light(js.lights, js.envs, jnp.asarray(idx), jnp.asarray(p),
                               jnp.asarray(u[0]), jnp.asarray(u[1]))
    got = t_light.sample_light(lights, torch.as_tensor(idx), torch.as_tensor(p),
                               torch.as_tensor(u[0]), torch.as_tensor(u[1]))
    for f in ("L", "wi", "pdf", "dist"):
        _close(getattr(got, f), getattr(ref, f), f"sample_light.{f}")
    np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(ref.is_delta))
    kinds = np.asarray(js.lights.kind)[idx]
    for k in (t_light.L_GONIO, t_light.L_PROJECTION, t_light.L_INFINITE):
        assert (np.asarray(ref.L)[kinds == k].max(-1) > 0).sum() > 50, k
    _close(t_light.light_pdf(lights, torch.as_tensor(idx), torch.as_tensor(p),
                             torch.as_tensor(wi)),
           j_light.light_pdf(js.lights, js.envs, jnp.asarray(idx), jnp.asarray(p),
                             jnp.asarray(wi)), "light_pdf")
    world_c = np.asarray([0.1, 0.5, -0.2], np.float32)
    ref = j_light.sample_light_ray(js.lights, js.envs, jnp.asarray(idx), jnp.asarray(world_c),
                                   3.5, *(jnp.asarray(x) for x in u))
    got = t_light.sample_light_ray(lights, torch.as_tensor(idx), torch.as_tensor(world_c), 3.5,
                                   *(torch.as_tensor(x) for x in u))
    for f in ("o", "d", "alpha"):
        _close(getattr(got, f), getattr(ref, f), f"sample_light_ray.{f}")


def _light_scene(tmp_path, kind, extra):
    """The port's version of test_longtail_components._light_scene: one
    image-driven light over a map whose top half is 4x its bottom."""
    img = np.full((16, 16, 3), 0.25, np.float32)
    img[:8, :, :] = 1.0
    fn = str(tmp_path / "map.pfm")
    write_image(fn, img)
    t_api._state.__init__()
    t_api.pbrt_init({"quiet": True})
    cam_p = ParamSet()
    cam_p.add("float", "fov", [45.0])
    t_api.pbrt_camera("perspective", cam_p)
    t_api.pbrt_world_begin()
    lp = ParamSet()
    lp.add("rgb", "I", [10.0, 10.0, 10.0])
    lp.add("string", "mapname", [fn])
    for k, vals in extra:
        lp.add(k.split()[0], k.split()[1], vals)
    t_api.pbrt_light_source(kind, lp)
    scene = t_compile(t_api.get_state().render_options, "cpu")
    t_api._state.__init__()
    return scene


def _L_at(scene, pts):
    p = torch.as_tensor(np.asarray(pts, np.float32))
    n = p.shape[0]
    ls = t_light.sample_light(scene.lights, torch.zeros((n,), dtype=torch.int64), p,
                              torch.full((n,), 0.5), torch.full((n,), 0.5))
    return t_spec.y(ls.L).numpy()


def test_goniometric_light_uses_map(tmp_path):
    """tests/test_longtail_components.py:56 on the port: a receiver seen
    through the map's bright half gets 4x the dim half."""
    scene = _light_scene(tmp_path, "goniometric", [])
    y = _L_at(scene, [[0.0, 0.0, 2.0], [0.0, 0.0, -2.0]])
    assert y[0] > 0 and y[1] > 0
    np.testing.assert_allclose(y[0] / y[1], 4.0, rtol=0.05)


def test_projection_light_frustum_and_map(tmp_path):
    """tests/test_longtail_components.py:67 on the port: the image
    modulates inside the fov frustum, zero outside."""
    scene = _light_scene(tmp_path, "projection", [("float fov", [40.0])])
    y = _L_at(scene, [[0.0, 0.0, 3.0], [0.0, 0.8, 3.0], [0.0, -0.8, 3.0], [3.0, 0.0, 0.0]])
    assert y[0] > 0
    assert y[3] == 0.0
    hi, lo = max(y[1], y[2]), min(y[1], y[2])
    assert lo > 0
    np.testing.assert_allclose(hi / lo, 4.0, rtol=0.08)


def test_env_lit_slice_matches_jax(tmp_path, monkeypatch):
    """16x16, 4 spp, path maxdepth 2, halton: an exinfinite map, a
    goniometric and a projection light over the slice scene, through
    both entry points at the same seed; agree()'s limits (image mean
    within 0.5%, 99% of pixels within 1e-3 relative). The JAX package's
    halton sampler reads its prime table as a device array with int()
    inside its jitted tile (a tracer error, ROADMAP R12); the test hands
    it the same primes as a NumPy array, which changes no arithmetic.
    Observed on the CPU: every pixel within 1.5e-5."""
    monkeypatch.setattr(j_sampling, "_PRIMES", np.asarray(j_sampling._PRIMES))
    path = tmp_path / "scene.pbrt"
    path.write_text(lit_scene_text(light_images(str(tmp_path))))
    ref = _render(j_api, j_parser, path)
    got = _render(t_api, t_parser, path)
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99
