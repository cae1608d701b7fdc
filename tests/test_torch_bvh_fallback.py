"""The pure-Python BVH builders of the port (accel/bvh.py's fallback when
the native builder cannot be built or returns no nodes) against the JAX
package's Python builders, each package forced onto its fallback here
(the JAX package's native_build_bvh returns None; the port's native
loader raises the error a failed g++ raises).

Trees: node_lo, node_hi, node_meta and the leaf order identical, array
for array (the same NumPy operations in the same dtypes), for sah,
middle, equal, aac and an unknown method (SAH), on 500 boxes and on the
primitive bounds of a scene with triangles and quadrics; the wide trees
built from them identical too. A render through make_accel on the
fallback tree (K2's plain twin) matches the JAX package's render on its
fallback tree (the binary-tree walk) within the whole-slice limits of
tests/test_torch_slice.py: image mean within 0.5%, 99% of pixels
within 1e-3 relative.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
import pbrt_tpu.native  # noqa: E402
from pbrt_tpu.accel import bvh as j_bvh  # noqa: E402
from pbrt_tpu.accel.wide_bvh import build_wide_bvh as j_build_wide_bvh  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu.scene.compile import compile_scene as j_compile  # noqa: E402
from pbrt_tpu_torch import bridge  # noqa: E402
from pbrt_tpu_torch.accel import bvh as t_bvh  # noqa: E402
from pbrt_tpu_torch.core import error as t_error  # noqa: E402
from pbrt_tpu_torch.core.error import PbrtError  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile  # noqa: E402
from test_torch_slice import _parse, _render, scene_text  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

GPP_FAILED = "g++ failed building the BVH builder:\nbvh_builder.cpp: fatal error"
QUADRICS = ('AttributeBegin\nTranslate 0.5 2.2 0\nShape "sphere" "float radius" [0.4]\n'
            'AttributeEnd\nAttributeBegin\nTranslate -2.5 0.3 1\nRotate 90 1 0 0\n'
            'Shape "cylinder" "float radius" [0.2]\nAttributeEnd\n')


@pytest.fixture
def fallback(monkeypatch):
    """Both packages on their Python builders for the test's length."""
    def refuse():
        raise PbrtError(GPP_FAILED)

    monkeypatch.setattr(pbrt_tpu.native, "native_build_bvh", lambda *a: None)
    monkeypatch.setattr(t_bvh, "_load_native", refuse)
    monkeypatch.setattr(t_bvh, "_native_warned", False)
    monkeypatch.setattr(t_error, "quiet", False)   # a --quiet parse earlier in this process


def box_geom():
    """tests/test_tools.py's 500 boxes as degenerate triangles whose
    bounds are the boxes (up to rounding): (v0, e1, e2), and the JAX
    package's view of them as a geometry."""
    rng = np.random.RandomState(3)
    c = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
    lo, hi = c - 0.05, c + 0.05
    d = hi - lo
    v0, e1, e2 = lo, d * np.float32([1, 1, 0]), d * np.float32([0, 0, 1])
    jg = types.SimpleNamespace(
        tri_v0=v0, tri_e1=e1, tri_e2=e2, tri_dv0=None, quad_type=np.zeros(0, np.int32),
        quad_o2w=np.zeros((0, 4, 4)), quad_o2w_end=None, quad_params=np.zeros((0, 8)),
        world_lo=lo.min(0) - np.float32(1e-3), world_hi=hi.max(0) + np.float32(1e-3))
    return (v0, e1, e2), jg


def assert_same_tree(got, ref):
    for f, a, b in zip(t_bvh.BVH._fields, got, ref):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype), err_msg=f)


@pytest.mark.parametrize("method", ["sah", "middle", "equal", "aac", "bogus"])
def test_python_trees_match_jax_on_boxes(fallback, method, capsys):
    """The port's Python tree over the 500 boxes equals the JAX
    package's Python tree array for array (dtypes included); it passes
    tests/test_tools.py's invariants (chip_smoke.py [32]'s checker); an
    unknown method warns and builds SAH in both."""
    tris, jg = box_geom()
    ref = j_bvh.build_bvh(jg, method)
    got = t_bvh.build_bvh(*tris, method, world=(jg.world_lo, jg.world_hi))
    assert_same_tree(got, ref)
    assert got.node_lo.dtype == got.node_hi.dtype == np.float32
    assert got.node_meta.dtype == got.prim_ids.dtype == np.int32
    assert got.n_nodes == ref.n_nodes == len(got.node_meta)
    lo, hi = t_bvh._tri_bounds(*tris)
    leaves = chip_smoke.bvh_invariants(got, lo, hi)
    assert leaves >= 500 // t_bvh.LEAF_MAX
    if method == "aac":
        assert leaves == 500 and got.n_nodes == 999   # one prim a leaf, a binary tree
    err = capsys.readouterr().err
    assert ('unknown; using "sah"' in err) == (method == "bogus")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """tests/test_torch_slice.py's scene with a sphere and a cylinder
    (292 triangles, 2 quadrics) compiled by both packages."""
    path = tmp_path_factory.mktemp("fallback") / "scene.pbrt"
    path.write_text(scene_text(res=16, spp=1, depth=2).replace("WorldEnd", QUADRICS + "WorldEnd"))
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    assert ts.geom.n_tris == js.geom.n_tris == 292 and ts.geom.n_quads == 2
    return path, js, ts


@pytest.mark.parametrize("method", ["sah", "aac"])
def test_python_trees_match_jax_on_scene_bounds(fallback, small, method):
    """make_accel's fallback trees over the scene's primitive bounds
    (triangles, then the quadric boxes; AAC in the scene's world bounds)
    equal the JAX package's build_bvh on its fallback: the binary tree
    (force="bvh") and the wide tree built from it (force="wide")
    against pbrt_tpu.accel.wide_bvh.build_wide_bvh."""
    _, js, ts = small
    ref = j_bvh.build_bvh(js.geom, method)
    assert len(ref.prim_ids) == 294
    assert_same_tree(t_bvh.make_accel(ts.geom, method, force="bvh").bvh, ref)
    lo, hi = t_bvh.prim_bounds(ts.geom)
    chip_smoke.bvh_invariants(ref, lo, hi)
    tw = t_bvh.make_accel(ts.geom, method, force="wide").wide
    jw = j_build_wide_bvh(ref, js.geom)
    assert tw.n_blocks == jw.n_blocks
    for f in bridge.WIDE_FIELDS:
        np.testing.assert_array_equal(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)),
                                      err_msg=f)


def test_fallback_when_gpp_is_missing(monkeypatch, tmp_path, capsys):
    """With no g++ on the host (running it raises FileNotFoundError) the
    port builds with the Python builders: the JAX package's Python tree,
    one warning a process that names the failure, and g++ tried once."""
    calls = []

    def no_gpp(*args, **kw):
        calls.append(args)
        raise FileNotFoundError(2, "No such file or directory", "g++")

    monkeypatch.setattr(pbrt_tpu.native, "native_build_bvh", lambda *a: None)
    monkeypatch.setattr(t_bvh, "_LIB", None)
    monkeypatch.setattr(t_bvh, "_NATIVE_ERROR", None)
    monkeypatch.setattr(t_bvh, "_native_warned", False)
    monkeypatch.setattr(t_error, "quiet", False)
    monkeypatch.setattr(t_bvh, "_BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(t_bvh.subprocess, "run", no_gpp)
    tris, jg = box_geom()
    ref = j_bvh.build_bvh(jg, "sah")
    for _ in range(2):
        assert_same_tree(t_bvh.build_bvh(*tris, "sah"), ref)
    assert len(calls) == 1
    warned = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("Warning")]
    assert len(warned) == 1 and "Python builders" in warned[0] and "g++" in warned[0]
    with pytest.raises(PbrtError, match="cannot build the BVH builder"):
        t_bvh._load_native()


def test_fallback_when_the_native_build_returns_no_nodes(monkeypatch, capsys):
    """A native build that returns no nodes falls back as the JAX
    package's does (native_build_bvh -> None there), with the warning."""
    lib = types.SimpleNamespace(pbrt_build_bvh=lambda *a: 0)
    monkeypatch.setattr(pbrt_tpu.native, "native_build_bvh", lambda *a: None)
    monkeypatch.setattr(t_bvh, "_load_native", lambda: lib)
    monkeypatch.setattr(t_bvh, "_native_warned", False)
    monkeypatch.setattr(t_error, "quiet", False)
    tris, jg = box_geom()
    assert_same_tree(t_bvh.build_bvh(*tris, "aac", world=(jg.world_lo, jg.world_hi)),
                     j_bvh.build_bvh(jg, "aac"))
    assert "returned 0 nodes over 500 prims" in capsys.readouterr().err


def test_fallback_render_matches_jax(fallback, small, monkeypatch):
    """The scene at 16^2 under Accelerator "bvh" "splitmethod" "aac",
    each package on its Python tree: the port through make_accel's wide
    route (K2's plain twin over the wide tree of its Python AAC tree),
    the JAX package through its binary-tree walk over its Python AAC
    tree; images within the whole-slice limits."""
    path, _, _ = small
    aac = path.with_name("aac.pbrt")
    aac.write_text(path.read_text().replace(
        "WorldBegin", 'Accelerator "bvh" "string splitmethod" "aac"\nWorldBegin'))
    built = []
    j_make = j_bvh.make_accel
    monkeypatch.setattr(j_bvh, "make_accel", lambda geom, split, force="": built.append(
        split) or j_make(geom, split, force="bvh"))
    monkeypatch.setattr(t_bvh, "WIDE_THRESHOLD", 1)
    t_make = t_bvh.make_accel
    routes = []

    def t_route(geom, split, force=""):
        acc = t_make(geom, split, force)
        routes.append((split, acc.wide is not None))
        return acc

    monkeypatch.setattr(t_bvh, "make_accel", t_route)
    ref = _render(j_api, j_parser, aac)
    got = _render(t_api, t_parser, aac)
    assert built == ["aac"] and routes == [("aac", True)]
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99
