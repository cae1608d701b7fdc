"""Bump mapping, alpha masks and the textured slice as a whole, port
against the JAX package.

- eval_bump: both packages compile a scene whose materials carry a
  `wrinkled` and an `imagemap` bump map; a hit batch made with NumPy
  from a seed (uv in [0.2, 2], so the finite-difference steps
  du = dv = (|u| + 1e-3) / 2 stay >= 0.1) goes to both. Frames within
  rtol 1e-4 / atol 1e-5: the displacement differences are divided by the
  steps, which scales the textures' float differences (rtol 1e-5) up
  to ten times.
- Alpha masks: a quad masked by a 2D checkerboard in front of a second
  quad, and a quad with alpha 0. `_alpha_of` within 1e-6;
  `_intersect_alpha` (and `intersect_p`, which runs the same loop) with
  prim identical and t within 1e-5 relative (the triangle limits of
  tests/test_torch_intersect.py).

The slice as a whole (every new material kind, textures, bump maps and
an alpha mask in one render) is held in tests/test_torch_textured_slice.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.accel.intersect import Hit as JHit
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.integrators.surface import make_frame as j_make_frame
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.scene.compile import eval_bump as j_eval_bump
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.integrators.surface import make_frame, shading_frame
from pbrt_tpu_torch.io.image import write_image
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

H = 2048


def tri_quad(corners, uv=True):
    pts = " ".join(f"{v:g}" for c in corners for v in c)
    s = f'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [{pts}]'
    return s + (' "float uv" [0 0 1 0 1 1 0 1]\n' if uv else "\n")


def bump_scene(img_path):
    return ('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
            'LookAt 0 0 -5 0 0 0 0 1 0\nCamera "perspective"\nWorldBegin\n'
            'Texture "wr" "float" "wrinkled" "integer octaves" [5]\n'
            'Texture "bw" "float" "scale" "texture tex1" "wr" "float tex2" [.05]\n'
            f'Texture "im" "float" "imagemap" "string filename" "{img_path}" '
            '"float scale" [.03]\n'
            'Material "plastic" "texture bumpmap" "bw"\n' + tri_quad([(0, 0, 0), (1, 0, 0),
                                                                       (1, 1, 0), (0, 1, 0)])
            + 'Material "matte" "texture bumpmap" "im"\n' + tri_quad([(2, 0, 0), (3, 0, 0),
                                                                      (3, 1, 0), (2, 1, 0)])
            + 'Material "matte"\n' + tri_quad([(4, 0, 0), (5, 0, 0), (5, 1, 0), (4, 1, 0)])
            + "WorldEnd\n")


def test_eval_bump_matches_jax(tmp_path):
    rng = np.random.RandomState(31)
    img = tmp_path / "bump.pfm"
    write_image(str(img), rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    path = tmp_path / "bump.pbrt"
    path.write_text(bump_scene(img))
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    ns = unit(rng.normal(size=(H, 3)))
    hits = {"hit.valid": np.ones(H, bool), "hit.t": np.ones(H, np.float32),
            "hit.p": rng.uniform(-2, 2, (H, 3)).astype(np.float32),
            "hit.ng": ns, "hit.ns": ns,
            "hit.uv": (rng.uniform(0.2, 2, (H, 2)) * rng.choice([-1, 1], (H, 2))).astype(
                np.float32),
            "hit.dpdu": (np.cross(ns, unit(rng.normal(size=(H, 3))))
                         * rng.uniform(0.5, 2, (H, 1))).astype(np.float32),
            "hit.mat": rng.randint(-1, 3, H).astype(np.int32),
            "hit.light": np.full(H, -1, np.int32), "hit.prim": np.zeros(H, np.int32)}
    jhit = JHit(**{f: jnp.asarray(hits[f"hit.{f}"]) for f in JHit._fields})
    thit = bridge.hit_from_arrays(hits, "cpu")
    ref = j_eval_bump(js, jhit, j_make_frame(jhit))
    got = shading_frame(ts, thit)
    plain = make_frame(thit)
    for f in ("ss", "ts", "ns", "ng"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    mat = hits["hit.mat"]
    tilt = 1.0 - np.sum(got.ns.numpy() * plain.ns.numpy(), -1)
    assert (tilt[mat == 0] > 1e-6).mean() > 0.9 and (tilt[mat == 1] > 1e-6).mean() > 0.9
    assert np.all(tilt[mat >= 2] < 1e-6) and np.all(tilt[mat < 0] < 1e-6)


def alpha_scene():
    return ('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
            'LookAt 0 0 -5 0 0 0 0 1 0\nCamera "perspective"\nWorldBegin\n'
            'Texture "chk" "float" "checkerboard" "float tex1" [1] "float tex2" [0] '
            '"float uscale" [4] "float vscale" [4]\n'
            'Material "matte"\n'
            'AttributeBegin\n' + tri_quad([(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0)])[:-1]
            + ' "texture alpha" "chk"\nAttributeEnd\n'
            'AttributeBegin\n' + tri_quad([(-1, -1, 0.5), (0, -1, 0.5), (0, 1, 0.5),
                                           (-1, 1, 0.5)])[:-1]
            + ' "float alpha" [0]\nAttributeEnd\n'
            + tri_quad([(-2, -2, 1), (2, -2, 1), (2, 2, 1), (-2, 2, 1)]) + "WorldEnd\n")


@pytest.fixture(scope="module")
def alpha(tmp_path_factory):
    path = tmp_path_factory.mktemp("alpha") / "alpha.pbrt"
    path.write_text(alpha_scene())
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    rng = np.random.RandomState(32)
    n = 1024
    o = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                  np.full(n, -3.0)], -1).astype(np.float32)
    d = np.stack([rng.normal(0, 0.05, n), rng.normal(0, 0.05, n), np.ones(n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    tmax = np.where(rng.rand(n) < 0.05, -1.0, 1e30).astype(np.float32)
    jray = JRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax),
                jnp.zeros(n, jnp.float32))
    tray = Ray(*(torch.as_tensor(x) for x in (o, d, tmin, tmax, np.zeros(n, np.float32))))
    return js, ts, jray, tray


def test_alpha_of_matches_jax(alpha):
    js, ts, jray, tray = alpha
    jh = js.accel.intersect(jray)
    th = ts.accel.intersect(tray)
    np.testing.assert_array_equal(th.prim.numpy(), np.asarray(jh.prim))
    a_ref = np.asarray(js._alpha_of(jh))
    a = ts._alpha_of(th).numpy()
    np.testing.assert_allclose(a, a_ref, atol=1e-6)
    assert 0.2 < (a == 0).mean() < 0.8      # the mask cuts both ways


def test_intersect_alpha_matches_jax(alpha):
    js, ts, jray, tray = alpha
    ref = js.intersect(jray)
    got = ts.intersect(tray)
    prim = got.prim.numpy()
    np.testing.assert_array_equal(prim, np.asarray(ref.prim))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    v = got.valid.numpy()
    np.testing.assert_allclose(got.t.numpy()[v], np.asarray(ref.t)[v], rtol=1e-5)
    # masked hits were skipped: the front quad (prims 0-1) is hit only
    # where the checkerboard is 1, the alpha-0 quad (prims 2-3) never
    assert not np.isin(prim, [2, 3]).any()
    assert np.isin(prim, [0, 1]).any() and np.isin(prim, [4, 5]).any()
    assert np.all(ts._alpha_of(got).numpy()[v] > 0)
    np.testing.assert_array_equal(ts.intersect_p(tray).numpy(),
                                  np.asarray(js.intersect_p(jray)))
