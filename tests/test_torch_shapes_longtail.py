"""The port's tessellated shapes (heightfield, loopsubdiv, nurbs) against
the JAX package's.

Both packages tessellate on the host with the same NumPy code, so the
TriangleData (p, indices, n, uv) must be identical, array for array.
Then a 16 x 16 render of each shape (directlighting, one point light,
4 spp) through both packages at the same seed, within the whole-slice
limits of tests/test_torch_slice.py: image mean within 0.5%, at least
99% of pixels within 1e-3 relative.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.core.transform import Transform as JTransform
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.paramset import ParamSet as JParamSet
from pbrt_tpu.shapes.registry import make_shape as j_make_shape
from pbrt_tpu_torch.core.transform import Transform as TTransform
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.paramset import ParamSet as TParamSet
from pbrt_tpu_torch.shapes.registry import make_shape as t_make_shape
from test_longtail_components import _icosahedron

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def _heightfield_params():
    nu, nv = 9, 7
    x, y = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="xy")
    pz = 0.3 * np.sin(5 * x) * np.cos(4 * y)
    return [("integer", "nu", [nu]), ("integer", "nv", [nv]),
            ("float", "Pz", pz.ravel().tolist())]


def _loopsubdiv_params():
    """The icosahedron of tests/test_longtail_components.py:102."""
    v, f = _icosahedron()
    return [("integer", "nlevels", [2]), ("integer", "indices", f.ravel().tolist()),
            ("point", "P", v.ravel().tolist())]


def _nurbs_params():
    """A curved biquadratic patch."""
    return [("integer", "nu", [3]), ("integer", "nv", [3]), ("integer", "uorder", [3]),
            ("integer", "vorder", [3]), ("float", "uknots", [0, 0, 0, 1, 1, 1]),
            ("float", "vknots", [0, 0, 0, 1, 1, 1]),
            ("point", "P", [0, 0, 0, 1, 0, 0.5, 2, 0, 0, 0, 1, 0.5, 1, 1, 1.5, 2, 1, 0.5,
                            0, 2, 0, 1, 2, 0.5, 2, 2, 0])]


def _bilinear_params():
    """The bilinear patch of tests/test_longtail_components.py:135."""
    return [("integer", "nu", [2]), ("integer", "nv", [2]), ("integer", "uorder", [2]),
            ("integer", "vorder", [2]), ("float", "uknots", [0.0, 0.0, 1.0, 1.0]),
            ("float", "vknots", [0.0, 0.0, 1.0, 1.0]),
            ("point", "P", [0, 0, 0, 2, 0, 0, 0, 3, 0, 2, 3, 0])]


SHAPES = {"heightfield": ("heightfield", _heightfield_params),
          "loopsubdiv": ("loopsubdiv", _loopsubdiv_params),
          "nurbs": ("nurbs", _nurbs_params),
          "nurbs_bilinear": ("nurbs", _bilinear_params)}


def _make(make_shape, ParamSet, Transform, name, params):
    ps = ParamSet()
    for decl, key, vals in params:
        ps.add(decl, key, vals)
    o2w = Transform.translate([0.2, -0.5, 0.3]) * Transform.rotate(30.0, [0.3, 1.0, 0.2])
    return make_shape(name, ps, o2w, o2w.inverse(), False)


@pytest.mark.parametrize("case", list(SHAPES))
def test_tessellation_identical_to_jax(case):
    name, params = SHAPES[case]
    got = _make(t_make_shape, TParamSet, TTransform, name, params())
    ref = _make(j_make_shape, JParamSet, JTransform, name, params())
    assert len(got.triangles) == len(ref.triangles) == 1 and not got.quadrics
    g, r = got.triangles[0], ref.triangles[0]
    assert len(g.indices) > 0
    for f in ("p", "indices", "n", "uv"):
        a, b = getattr(g, f), getattr(r, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _scene_text(name, params):
    decl = " ".join(f'"{d} {k}" [{" ".join(str(v) for v in vals)}]' for d, k, vals in params)
    return ('Film "image" "integer xresolution" [16] "integer yresolution" [16]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [4]\n'
            'LookAt 1 2.5 -3  0.8 0.3 0.5  0 1 0\nCamera "perspective" "float fov" [55]\n'
            'SurfaceIntegrator "directlighting" "integer maxdepth" [1]\nWorldBegin\n'
            'LightSource "point" "point from" [1 4 -3] "rgb I" [30 30 30]\n'
            'AttributeBegin\nTranslate 0 -0.2 0\nRotate -80 1 0 0\n'
            'Material "plastic" "rgb Kd" [.5 .4 .3] "rgb Ks" [.3 .3 .3]\n'
            f'Shape "{name}" {decl}\nAttributeEnd\n'
            'AttributeBegin\nTranslate 0 -1 0\nRotate -90 1 0 0\nMaterial "matte"\n'
            'Shape "disk" "float radius" [6]\nAttributeEnd\nWorldEnd\n')


def _render(api, parser, path):
    # one tile of exactly the image's samples in both packages: no padding
    opts = {"quiet": True, "write": False, "tile_samples": 16 * 16 * 4}
    if api is t_api:
        opts["device"] = "cpu"
    api.pbrt_init(opts)
    try:
        parser.parse_file(str(path))
        return np.asarray(api._state.output)
    finally:
        api._state.__init__()


@pytest.mark.parametrize("case", ["heightfield", "loopsubdiv", "nurbs"])
def test_render_matches_jax(tmp_path, case):
    name, params = SHAPES[case]
    path = tmp_path / "scene.pbrt"
    path.write_text(_scene_text(name, params()))
    ref = _render(j_api, j_parser, path)
    got = _render(t_api, t_parser, path)
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99
