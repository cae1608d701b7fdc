"""The port's spot and distant lights, emitted-ray sampling, rainbow
transfer and photon shooter against the JAX package.

Both packages compile PHOTON_SCENE (a spot, a distant, a point, a
triangle area and a sphere area light; a homogeneous medium and a
rainbow region; a dispersive glass sphere over a matte floor and wall)
and `disp` (tests/goldens); the JAX arrays, handed over by bridge.py,
feed the port's light functions. Points, directions and uniforms come
from a seed with NumPy. One shooting batch of 1,024 paths runs through
both packages at the same counters.

Limits: the compiled arrays are identical; light samples and emitted
rays within 1e-4 relative, atol 1e-6 (the light-value limit of
tests/test_torch_bsdf.py: a grazing area-light pdf differs by 2e-5);
the rainbow transfer within 1e-4 relative plus 1e-3 of its row's peak
(the angle comes from arccos, whose float32 rounding differs between
XLA and ATen, and sets the two band-filter weights, which move 158 nm
per degree: a weight near 0 carries the angle's error);
shooter records: classes identical on at least 99.9% of records, and
where a photon is stored by both, positions and directions within 1e-4
and powers within 1e-4 relative.
"""
import os

import numpy as np
import pytest
import torch

from pbrt_tpu.lights import lighting as j_light
from pbrt_tpu.photon import shooter as j_shoot
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.volumes import registry as j_vol
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.lights import lighting as t_light
from pbrt_tpu_torch.photon import shooter as t_shoot
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from pbrt_tpu_torch.volumes import registry as t_vol
from photon_scenes import PHOTON_SCENE
from test_reference_golden import GOLDEN_DIR
from test_torch_quadrics import assert_compile_parity
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def compiled(tmp_path_factory, name, text):
    path = tmp_path_factory.mktemp(name) / "scene.pbrt"
    path.write_text(text)
    jro, tro = _parse(j_api, j_parser, path), _parse(t_api, t_parser, path)
    js, ts = j_compile(jro), t_compile(tro, "cpu")
    ref = assert_compile_parity(js, ts)
    return js, ts, bridge.from_arrays(ref, "lights", "cpu"), jro, tro


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return compiled(tmp_path_factory, "photon", PHOTON_SCENE)


@pytest.fixture(scope="module")
def disp(tmp_path_factory):
    with open(os.path.join(GOLDEN_DIR, "disp.pbrt")) as f:
        return compiled(tmp_path_factory, "disp", f.read())


def close(got, ref, rtol=1e-4, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def test_lights_compile(scene):
    js, ts = scene[:2]
    kinds = ts.lights.kind.tolist()
    assert kinds == [t_light.L_SPOT, t_light.L_DISTANT, t_light.L_POINT, t_light.L_AREA,
                     t_light.L_AREA]
    assert kinds == np.asarray(js.lights.kind).tolist()


def test_sample_light_matches_jax(scene):
    js, _, lights = scene[:3]
    n = 5 * 800
    rng = np.random.RandomState(1)
    p = rng.uniform([-2, -0.5, -2], [2, 2.5, 2], (n, 3)).astype(np.float32)
    p[:400] = rng.uniform([0.2, -0.5, -0.2], [0.6, 0.5, 0.2], (400, 3))   # in the spot's beam
    idx = np.repeat(np.arange(5), 800).astype(np.int32)
    u1, u2 = rng.rand(2, n).astype(np.float32)
    ref = j_light.sample_light(js.lights, js.envs, idx, p, u1, u2)
    got = t_light.sample_light(lights, torch.as_tensor(idx), *(torch.as_tensor(x)
                                                               for x in (p, u1, u2)))
    for f in ("L", "wi", "pdf", "dist"):
        close(getattr(got, f).numpy(), getattr(ref, f), what=f)
    np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(ref.is_delta))
    spot = got.L.numpy()[:800, 0]
    assert (spot > 0).any() and (spot == 0).any()    # inside and outside the cone
    wl = t_light.spot_falloff(torch.linspace(0.9, 1.0, 101), torch.tensor(0.93),
                              torch.tensor(0.96))
    assert wl[0] == 0 and wl[-1] == 1 and ((wl > 0) & (wl < 1)).any()


def test_sample_light_ray_matches_jax(scene):
    js, ts, lights = scene[:3]
    n = 5 * 1000
    rng = np.random.RandomState(2)
    idx = np.repeat(np.arange(5), 1000).astype(np.int32)
    u = rng.rand(4, n).astype(np.float32)
    world_c = (0.5 * (js.world_lo + js.world_hi)).astype(np.float32)
    world_rad = float(np.linalg.norm(js.world_hi - js.world_lo) * 0.5) + 1e-3
    ref = j_light.sample_light_ray(js.lights, js.envs, idx, world_c, world_rad, *u)
    got = t_light.sample_light_ray(lights, torch.as_tensor(idx), torch.as_tensor(world_c),
                                   world_rad, *(torch.as_tensor(x) for x in u))
    for f in ("o", "d", "alpha"):
        close(getattr(got, f).numpy(), getattr(ref, f), what=f)
    d = got.d.numpy()
    assert np.allclose(d[1000:2000], d[1000])                        # distant: one direction
    assert (got.alpha.numpy()[:1000, 0] > 0).all()


def test_rainbow_reflection_matches_jax():
    rng = np.random.RandomState(3)
    n = 6000
    w = rng.normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    # incident directions at angles over the bows and beyond
    theta = np.deg2rad(rng.uniform(0, 70, n))
    a = np.cross(w, rng.normal(size=(n, 3)))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    wi = -w * np.cos(theta)[:, None] + a * np.sin(theta)[:, None]
    L = rng.uniform(0, 5, (n, 30))
    w, wi, L = (x.astype(np.float32) for x in (w, wi, L))
    ref = np.asarray(j_vol.rainbow_reflection(L, w, wi))
    got = t_vol.rainbow_reflection(*(torch.as_tensor(x) for x in (L, w, wi))).numpy()
    assert (np.abs(got - ref) <= 1e-4 * np.abs(ref) + 1e-3 * ref.max(-1, keepdims=True)).all()
    close(got, ref, rtol=1e-3, what="rainbow")
    assert (got.argmax(-1) != 0).any() and (got > 0).all()


def shoot_both(js, ts, B=1024, shot_base=4096, seed=3):
    import jax.numpy as jnp

    hv = js.volume is not None
    ref = j_shoot._shoot_batch_fn(js, 5, hv, use_jit=False)(
        jnp.arange(B, dtype=jnp.int32), jnp.full((B,), shot_base, jnp.int32), seed)
    got = t_shoot.shoot_batch_fn(ts, 5, hv)(torch.arange(B), torch.full((B,), shot_base), seed)
    names = ("pos", "alpha", "wi", "cls", "n", "rho_r", "rho_t", "rp")
    return {k: np.asarray(v) for k, v in zip(names, ref)}, {k: v.numpy() for k, v in got.items()}


@pytest.mark.parametrize("which", ["disp", "scene"])
def test_shoot_batch_matches_jax(scene, disp, which):
    js, ts = (disp if which == "disp" else scene)[:2]
    ref, got = shoot_both(js, ts)
    cj, ct = ref["cls"], got["cls"]
    assert cj.shape == ct.shape == (1024, 10)
    assert (cj == ct).mean() >= 0.999
    both = (cj == ct) & (cj > 0)
    counts = np.bincount(cj[both], minlength=5)
    assert counts[3] > 50 and counts[1] > 0 and counts[2] > 0 and counts[4] > 0, counts
    if which == "scene":
        assert counts[2] > 10 and counts[4] > 5, counts
    for f in ("pos", "wi"):
        close(got[f][both], ref[f][both], rtol=0, atol=1e-4, what=f)
    close(got["alpha"][both], ref["alpha"][both], rtol=1e-4, atol=1e-4 * ref["alpha"].max(),
          what="alpha")
    rp = ref["rp"] & both
    assert rp.any() and (got["rp"][both] == ref["rp"][both]).mean() >= 0.999
    for f in ("n", "rho_r", "rho_t"):
        close(got[f][rp], ref[f][rp], rtol=1e-4, atol=1e-4, what=f)

