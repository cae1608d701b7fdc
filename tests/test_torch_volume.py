"""The port's volume regions and volume integrators against the JAX package.

Both packages compile the same scenes (all four region kinds: homogeneous,
rainbow as a density region, volumegrid and exponential, one of them
transformed); the JAX arrays, handed over by bridge.py, feed both
packages' functions. Points, rays and uniforms come from a seed with
NumPy.

Limits: the compiled arrays are identical; the transmittance position
hash is identical bit for bit; densities, coefficients and span ends
within 1e-5 relative; optical thickness, transmittance and the
integrators' radiance within 1e-4 relative (sums of up to 128 steps and
exp, whose float32 rounding differs between XLA and ATen). A ray may
differ in whether it enters a box only where it grazes it (the entry and
exit t within 1e-4); the tests count those rays.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.core import sampling as j_samp
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.integrators import volume as j_vint
from pbrt_tpu.renderers import driver as j_driver
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.volumes import registry as j_vol
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import sampling as t_samp
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.integrators import volume as t_vint
from pbrt_tpu_torch.renderers import driver as t_driver
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from pbrt_tpu_torch.volumes import registry as t_vol
from test_torch_quadrics import assert_compile_parity
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

HEAD = """Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
SurfaceIntegrator "directlighting"
VolumeIntegrator "single" "float stepsize" [0.25]
WorldBegin
LightSource "point" "point from" [0 3 -3] "rgb I" [30 30 30]
AttributeBegin
  Translate 0 2.5 0  Rotate 90 1 0 0
  AreaLightSource "diffuse" "rgb L" [3 3 3]
  Shape "disk" "float radius" [0.6]
AttributeEnd
AttributeBegin
  Translate 0 -1.6 0  Rotate -90 1 0 0
  Material "matte" "rgb Kd" [.5 .5 .5]
  Shape "disk" "float radius" [5]
AttributeEnd
Shape "sphere" "float radius" [0.4]
"""
HOMOGENEOUS = """Volume "homogeneous" "point p0" [-1.5 -1.5 -1.5] "point p1" [1.5 1.5 1.5]
    "rgb sigma_a" [0.15 0.1 0.05] "rgb sigma_s" [0.3 0.35 0.4] "float g" [0.2]
AttributeBegin
  Translate 0.5 0.2 0  Rotate 25 0 1 1
  Volume "rainbow" "point p0" [-0.6 -0.6 -0.6] "point p1" [0.8 0.7 0.9]
      "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.5 0.4 0.3] "rgb Le" [0.2 0.1 0.05]
      "float g" [-0.3]
AttributeEnd
"""
DENSITY = """Volume "volumegrid" "point p0" [-1 -1.2 -0.5] "point p1" [1.2 0.8 1.5]
    "integer nx" [3] "integer ny" [4] "integer nz" [2]
    "float density" [0.1 0.5 0.9 0.3 0.7 1.1 0.2 0.4 0.6 0.8 1.0 1.2
                     1.3 0.2 0.5 0.6 0.1 0.9 0.4 0.3 0.8 0.7 0.5 1.4]
    "rgb sigma_a" [0.2 0.2 0.3] "rgb sigma_s" [0.6 0.5 0.4] "rgb Le" [0.1 0.2 0.3] "float g" [0.4]
Volume "exponential" "point p0" [-2 -1.5 -2] "point p1" [2 1 2] "float a" [0.8] "float b" [1.5]
    "vector updir" [0 1 0.2] "rgb sigma_a" [0.1 0.1 0.1] "rgb sigma_s" [0.2 0.3 0.4]
"""


def compiled(tmp_path_factory, name, text):
    path = tmp_path_factory.mktemp(name) / "scene.pbrt"
    path.write_text(text)
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    ref = assert_compile_parity(js, ts)
    return js, ts, bridge.from_arrays(ref, "volume", "cpu")


@pytest.fixture(scope="module")
def homog(tmp_path_factory):
    """A homogeneous and a transformed rainbow region: the closed-form tau."""
    return compiled(tmp_path_factory, "homog", HEAD + HOMOGENEOUS + "WorldEnd\n")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """All four kinds: the marched tau."""
    return compiled(tmp_path_factory, "mixed", HEAD + HOMOGENEOUS + DENSITY + "WorldEnd\n")


def rays(n, seed, origin=None):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)) if origin is None else np.tile(origin, (n, 1))
    d = rng.normal(size=(n, 3)) + ([0, 0, 1.5] if origin is not None else 0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def close(got, ref, rtol, atol=1e-6, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def test_build_volumes_all_kinds(mixed):
    js, ts, vol = mixed
    assert ts.volume.host_kind == (t_vol.V_HOMOGENEOUS, t_vol.V_RAINBOW, t_vol.V_GRID,
                                   t_vol.V_EXPONENTIAL)
    assert ts.volume.host_dims[2] == (3, 4, 2)
    assert vol.host_kind == ts.volume.host_kind and vol.host_dims == ts.volume.host_dims
    np.testing.assert_array_equal(np.asarray(js.volume.kind), [0, 3, 1, 2])


def test_sigma_at_matches_jax(mixed):
    js, _, vol = mixed
    p = np.random.RandomState(1).uniform(-2.2, 2.2, (4096, 3)).astype(np.float32)
    ref = j_vol.sigma_at(js.volume, p)
    got = t_vol.sigma_at(vol, torch.as_tensor(p))
    for name, a, b in zip(("sigma_a", "sigma_s", "Le", "g"), got, ref):
        close(a.numpy(), b, 1e-5, what=name)
    assert (got[0].numpy()[:, 0] > 0.2).sum() > 200    # the grid and exponential regions


def test_intersect_p_matches_jax(mixed):
    js, _, vol = mixed
    o, d = rays(4096, 2)
    tmin = np.zeros(4096, np.float32)
    tmax = np.where(np.arange(4096) % 4 == 0, 1.0, 1e7).astype(np.float32)
    hj, t0j, t1j = (np.asarray(x) for x in j_vol.intersect_p(js.volume, o, d, tmin, tmax))
    ht, t0t, t1t = (x.numpy() for x in t_vol.intersect_p(
        vol, *(torch.as_tensor(x) for x in (o, d, tmin, tmax))))
    graze = np.abs(t1j - t0j) < 1e-4
    assert ((hj != ht) <= graze).all() and (hj != ht).sum() <= 4
    both = hj & ht
    assert both.sum() > 2000
    close(t0t[both], t0j[both], 1e-5, what="t0")
    close(t1t[both], t1j[both], 1e-5, what="t1")


@pytest.mark.parametrize("which", ["closed form", "marched"])
def test_tau_and_transmittance_match_jax(homog, mixed, which):
    js, _, vol = homog if which == "closed form" else mixed
    n = 2048
    o, d = rays(n, 3)
    rng = np.random.RandomState(4)
    dist = rng.uniform(0.1, 6.0, n).astype(np.float32)
    dist[:100] = 1e30                      # towards a point at infinity
    u = rng.rand(n).astype(np.float32)
    hit, t0, t1 = (np.array(x) for x in j_vol.intersect_p(js.volume, o, d,
                                                            np.zeros(n, np.float32),
                                                            np.minimum(dist, 1e7)))
    tj = np.asarray(j_vol.tau(js.volume, o, d, t0, t1, 24, u))
    tt = t_vol.tau(vol, *(torch.as_tensor(x) for x in (o, d, t0, t1)), 24,
                   torch.as_tensor(u)).numpy()
    close(tt, tj, 1e-4, what="tau")
    assert (tj[hit].max(-1) > 0.05).mean() > 0.5
    trj = np.asarray(j_vint.transmittance(js.volume, o, d, dist, 24, u))
    trt = t_vint.transmittance(vol, *(torch.as_tensor(x) for x in (o, d, dist)), 24,
                               torch.as_tensor(u)).numpy()
    close(trt, trj, 1e-4, what="transmittance")
    assert (trt < 0.9).any() and (trt == 1.0).any()
    assert t_vint.transmittance(None, torch.as_tensor(o), torch.as_tensor(d),
                                torch.as_tensor(dist), 24, torch.as_tensor(u)).eq(1).all()


def test_phase_hg_matches_jax():
    rng = np.random.RandomState(5)
    c = rng.uniform(-1, 1, 4096).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, 4096).astype(np.float32)
    close(t_samp.phase_hg(torch.as_tensor(c), torch.as_tensor(g)).numpy(),
          j_samp.phase_hg(c, g), 1e-5)


def test_pick_n_steps_and_the_cap_warning(mixed, monkeypatch):
    """The step count equals the JAX package's, capped at 128 (quick: 32)
    as there; the port warns when the cap coarsens the stepsize."""
    js, _, vol = mixed
    said = []
    monkeypatch.setattr(t_vint, "warning", said.append)
    for step, cap in ((1.0, 128), (0.25, 128), (0.01, 128), (0.05, 32), (100.0, 128)):
        assert t_vint.pick_n_steps(vol, step, cap) == j_vint.pick_n_steps(js.volume, step, cap)
    assert len(said) == 2 and "capped at 128" in said[0] and "capped at 32" in said[1]


def test_transmittance_hash_is_bit_equal(homog, monkeypatch):
    """The jitter of the surface integrators' transmittance: bits of
    p * 4096 hashed with wrapping uint32 multiplies."""
    js, _, _ = homog
    rng = np.random.RandomState(6)
    p = np.concatenate([rng.uniform(-3, 3, (3000, 3)), rng.normal(0, 1e-3, (500, 3)),
                        rng.uniform(-1e6, 1e6, (500, 3)), np.zeros((1, 3))]).astype(np.float32)
    seen = []
    monkeypatch.setattr(j_vint, "transmittance", lambda *a: seen.append(np.asarray(a[5])))
    j_driver._make_transmittance_fn(js, 8)(p, p, p[:, 0])
    got = t_driver.position_hash_u(torch.as_tensor(p)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), seen[0].view(np.int32))
    assert 0.0 <= got.min() and got.max() < 1.0 and len(np.unique(got)) > 3900


def _camera_rays(n, seed):
    o, d = rays(n, seed, origin=np.array([0.0, 0.0, -4.0]))
    z = np.zeros(n, np.float32)
    return o, d, z, np.full(n, np.inf, np.float32), z


@pytest.mark.parametrize("which", ["emission", "single"])
def test_volume_integrators_match_jax(mixed, which):
    """li_emission and li_single (a light sample, a shadow ray and a
    transmittance per step) over the same rays, surface distances and
    pixel/sample streams."""
    js, ts, _ = mixed
    n = 512
    r = _camera_rays(n, 7)
    t_surf = t_driver.first_hit_t(ts, Ray(*(torch.as_tensor(x) for x in r)))[0]
    pixel = np.arange(n, dtype=np.int64) * 7 + 3
    sidx = np.arange(n, dtype=np.int64) % 4
    steps = 12
    if which == "emission":
        ref = j_vint.li_emission(js.volume, JRay(*r), t_surf.numpy(), pixel.astype(np.int32),
                                 sidx.astype(np.int32), steps, 3)
        got = t_vint.li_emission(ts.volume, Ray(*(torch.as_tensor(x) for x in r)), t_surf,
                                 torch.as_tensor(pixel), torch.as_tensor(sidx), steps, 3)
    else:
        ref = j_vint.li_single(js, JRay(*r), t_surf.numpy(), pixel.astype(np.int32),
                               sidx.astype(np.int32), steps, 3)
        got = t_vint.li_single(ts, Ray(*(torch.as_tensor(x) for x in r)), t_surf,
                               torch.as_tensor(pixel), torch.as_tensor(sidx), steps, 3)
    close(got.Tr.numpy(), ref.Tr, 1e-4, what="Tr")
    close(got.L.numpy(), ref.L, 1e-4, atol=1e-6, what="L")
    assert got.L.numpy().max() > 1e-3 and (got.Tr.numpy() < 0.95).mean() > 0.3
