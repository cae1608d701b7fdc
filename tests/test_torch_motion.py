"""Motion blur and the binary-BVH walk of the port against the JAX
package's on the same inputs.

An animated scene (moving triangle meshes and quadrics, static ones
beside them) compiles to the same SceneGeom motion fields and wider
packs in both packages; the block scan at ray time, the quadric fold,
the packed reconstruct (both pack widths) and t_pass_bvh (force="bvh":
static and moving, closest and any-hit) agree; the port's binary tree
equals the JAX package's; make_accel routes as the JAX package does;
and the port's versions of tests/test_motion.py pass.
"""
import os
import sys
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import QUAD, QUAD_IDX, _parse, mesh, uv_sphere  # noqa: E402

from pbrt_tpu.accel import intersect as j_int  # noqa: E402
from pbrt_tpu.accel.bvh import build_bvh as j_build_bvh  # noqa: E402
from pbrt_tpu.accel.bvh import t_pass_bvh as j_t_pass_bvh  # noqa: E402
from pbrt_tpu.core.geometry import Ray as JRay  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu.scene.compile import compile_scene as j_compile  # noqa: E402
from pbrt_tpu_torch import bridge  # noqa: E402
from pbrt_tpu_torch.accel import bvh as t_bvh  # noqa: E402
from pbrt_tpu_torch.accel import intersect as t_int  # noqa: E402
from pbrt_tpu_torch.core.geometry import Ray  # noqa: E402
from pbrt_tpu_torch.core.transform import AnimatedTransform, Transform  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile  # noqa: E402
from pbrt_tpu_torch.scene.paramset import ParamSet  # noqa: E402
from pbrt_tpu_torch.scene.records import RenderOptions, ShapeRecord  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

MOVE = "ActiveTransform EndTime\n{}\nActiveTransform All\n"


def scene_text(moving: bool):
    """Three tessellated spheres (the middle one moving), a moving
    sphere, a static cylinder and disk, an instanced moving quad, and a
    floor; TransformTimes 0.5 2 (shutter-normalized time is not ray
    time)."""
    s = ('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
         'TransformTimes 0.5 2\nWorldBegin\n'
         'ObjectBegin "tile"\n' + mesh(QUAD * 0.3, QUAD_IDX) + 'ObjectEnd\n')
    for k in range(3):
        P, idx = uv_sphere(5, 0.5, (-1.5 + 1.5 * k, 0.5, 0.0))
        mv = MOVE.format("Translate 0.7 0.2 0") if (moving and k == 1) else ""
        s += f"AttributeBegin\n{mv}" + mesh(P, idx) + "AttributeEnd\n"
    mv = MOVE.format("Translate 0 0 1\nRotate 20 0 1 0") if moving else ""
    s += f'AttributeBegin\nTranslate 0 1.5 0\n{mv}Shape "sphere" "float radius" [0.4]\nAttributeEnd\n'
    s += ('AttributeBegin\nTranslate 1 0.2 -1\nShape "cylinder" "float radius" [0.2] '
          '"float zmin" [-0.3] "float zmax" [0.5]\nAttributeEnd\n'
          'AttributeBegin\nTranslate 0 -0.5 0\nRotate -90 1 0 0\nShape "disk" "float radius" [3]\n'
          'AttributeEnd\n')
    mv = MOVE.format("Translate 0.4 0 0.3") if moving else ""
    s += f'AttributeBegin\nTranslate -0.5 1 -1\nRotate -80 1 0 0\n{mv}ObjectInstance "tile"\nAttributeEnd\n'
    return s + mesh(QUAD * 4 + [0, -0.4, 0], QUAD_IDX) + "WorldEnd\n"


def jax_geom_arrays(js):
    out = {f"geom.{f}": np.asarray(getattr(js.geom, f)) for f in bridge.GEOM_FIELDS}
    for f in bridge.MOTION_FIELDS:
        if getattr(js.geom, f) is not None:
            out[f"geom.{f}"] = np.asarray(getattr(js.geom, f))
    if js.geom.has_motion:
        out["geom.time0"] = np.asarray(js.geom.time0)
        out["geom.time1"] = np.asarray(js.geom.time1)
    return out


@pytest.fixture(scope="module", params=[False, True], ids=["static", "moving"])
def scene(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("motion") / "scene.pbrt"
    path.write_text(scene_text(request.param))
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    return request.param, js, ts


def rays(n=3000, seed=0):
    """Rays through the scene: random, axis-aligned, short tmax, dead
    (tmax -1); times across the shutter and outside it."""
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * [6, 3, 2] - [3, 0.5, 5]).astype(np.float32)
    tgt = (rng.rand(n, 3) * [4, 2, 1] - [2, -0.2, 0.5]).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:20] = [0, 0, 1]
    d[20:30] = [1, 0, 0]
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[::7] = 4.0
    tmax[::13] = -1.0
    tm = (rng.rand(n) * 2.0 + 0.25).astype(np.float32)   # shutter [0.5, 2] and beyond
    tm[:5], tm[5:10] = 0.5, 2.0
    return o, d, tmin, tmax, tm


def jray(r):
    return JRay(*(jnp.asarray(x) for x in r))


def tray(r):
    return Ray(*(torch.as_tensor(x) for x in r))


def check_t(tt, pt, tj, pj, what):
    """prim identical; t within 1e-5 relative, with an absolute slack of
    5e-5 for the quadrics (a root solved in float32, which XLA contracts
    with FMAs; at a near-grazing hit on the moving sphere the two
    packages differ by up to 5e-5 at t ~ 4.8)."""
    np.testing.assert_array_equal(pt, pj, err_msg=f"{what}: prim")
    hit = pj >= 0
    assert hit.sum() > 300, what
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5, atol=5e-5, err_msg=f"{what}: t")
    np.testing.assert_array_equal(tt[~hit], tj[~hit], err_msg=f"{what}: miss t")


def test_motion_fields_match_jax(scene):
    """The compiled geometry equals the JAX compile's array for array:
    motion deltas, end transforms (with host-computed inverses), the
    packs (36 and 58 columns when animated, 27 and 34 when not) and the
    shutter times."""
    moving, js, ts = scene
    ref = jax_geom_arrays(js)
    got = bridge.to_arrays("geom", ts.geom)
    assert ts.geom.has_motion == moving == js.geom.has_motion
    assert set(got) == set(ref)
    for key in sorted(ref):
        np.testing.assert_array_equal(got[key], ref[key].astype(got[key].dtype), err_msg=key)
    assert ts.geom.tri_pack.shape[1] == (36 if moving else 27)
    assert ts.geom.quad_pack.shape[1] == (58 if moving else 34)
    np.testing.assert_array_equal(ts.world_lo, js.world_lo)
    np.testing.assert_array_equal(ts.world_hi, js.world_hi)


def test_block_scan_fold_and_reconstruct_match_jax(scene):
    """t_pass_brute at ray time, the quadric fold after it, and the
    packed reconstruct (both widths) against the JAX package's
    t_pass_brute (which folds its quadrics itself) and reconstruct."""
    moving, js, ts = scene
    geom = bridge.from_arrays(jax_geom_arrays(js), "geom", "cpu")
    r = rays()
    tj, pj = (np.asarray(x) for x in j_int.t_pass_brute(js.geom, jray(r)))
    tt, pt = t_int.t_pass_brute(geom, tray(r), block=128)
    tt, pt = t_int.quad_t_pass(geom, tray(r), tt, pt)
    check_t(tt.numpy(), pt.numpy(), tj, pj, "block scan + fold")
    assert (pj >= geom.n_tris).sum() > 100
    hj = j_int.reconstruct(js.geom, jray(r), jnp.asarray(tj), jnp.asarray(pj))
    ht = t_int.reconstruct(geom, tray(r), torch.tensor(tj), torch.tensor(pj).long())
    for f, tol in (("p", 1e-4), ("ng", 1e-4), ("ns", 1e-4), ("dpdu", 1e-4), ("uv", 1e-3)):
        a, b = getattr(ht, f).numpy(), np.asarray(getattr(hj, f))
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max() / 10),
                                   err_msg=f)
    for f in ("valid", "mat", "light", "prim"):
        np.testing.assert_array_equal(getattr(ht, f).numpy(), np.asarray(getattr(hj, f)), f)


def test_binary_tree_matches_jax(scene):
    """The port's tree over prim_bounds (end-of-shutter bounds unioned
    in) equals the JAX package's build_bvh, node for node."""
    _, js, ts = scene
    ref = j_build_bvh(js.geom, "sah")
    got = t_bvh.build_bvh_bounds(*t_bvh.prim_bounds(ts.geom), "sah")
    for f, a, b in zip(t_bvh.BVH._fields, got, ref):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)
    assert len(got.prim_ids) == ts.geom.n_tris + ts.geom.n_quads


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
def test_t_pass_bvh_matches_jax(scene, any_hit):
    """The per-ray walk on the JAX package's tree (bridged), triangles
    plus quadrics: prim identical, t as in check_t; the walk through
    make_accel(force="bvh") gives the same."""
    moving, js, ts = scene
    jb = j_build_bvh(js.geom, "sah")
    tree = bridge.from_arrays({f"bvh.{f}": np.asarray(getattr(jb, f))
                               for f in bridge.BVH_FIELDS}, "bvh", "cpu")
    geom = bridge.from_arrays(jax_geom_arrays(js), "geom", "cpu")
    r = rays(seed=1)
    tj, pj = (np.asarray(x) for x in j_t_pass_bvh(jb, js.geom, jray(r), any_hit=any_hit))
    t_bvh.walk_stats.update(traversals=0, iterations=0)
    tt, pt = t_bvh.t_pass_bvh(tree, geom, tray(r), any_hit=any_hit)
    check_t(tt.numpy(), pt.numpy(), tj, pj, "t_pass_bvh")
    assert t_bvh.walk_stats["traversals"] == 1 and t_bvh.walk_stats["iterations"] > 10
    accel = t_bvh.make_accel(ts.geom, force="bvh")
    assert accel.bvh is not None and accel.wide is None and accel.tri_soa is None
    ta, pa = accel._t_pass(tray(r), any_hit=any_hit)
    np.testing.assert_array_equal(pa.numpy(), pt.numpy())
    np.testing.assert_array_equal(ta.numpy(), tt.numpy())


def test_make_accel_routes_as_jax():
    """Wide (K2) only for static scenes from WIDE_THRESHOLD triangles;
    the binary walk above BVH_THRESHOLD primitives (here quadrics, with
    few triangles) or with force="bvh"; the flat t-pass (K1) for other
    static scenes; the block scan for other motion scenes; force="flat"
    skips both trees."""
    rng = np.random.RandomState(2)

    def geom(n_tris, n_quads, moving=False):
        a = {"geom.tri_v0": rng.rand(n_tris, 3), "geom.tri_e1": rng.rand(n_tris, 3) * 0.1,
             "geom.tri_e2": rng.rand(n_tris, 3) * 0.1,
             "geom.tri_n": np.zeros((n_tris, 3, 3)), "geom.tri_has_n": np.zeros(n_tris, bool),
             "geom.tri_uv": np.zeros((n_tris, 3, 2)), "geom.tri_mat": np.zeros(n_tris),
             "geom.tri_light": -np.ones(n_tris), "geom.world_lo": np.zeros(3),
             "geom.world_hi": np.ones(3), "geom.tri_pack": np.zeros((n_tris, 27))}
        if n_quads:
            m = np.tile(np.eye(4), (n_quads, 1, 1))
            m[:, :3, 3] = rng.rand(n_quads, 3) * 10
            a.update({"geom.quad_type": np.zeros(n_quads), "geom.quad_o2w": m,
                      "geom.quad_w2o": np.linalg.inv(m),
                      "geom.quad_params": np.tile([0.01, -0.01, 0.01, 6.3, 0, 0, 0, 0],
                                                  (n_quads, 1)),
                      "geom.quad_mat": np.zeros(n_quads), "geom.quad_light": -np.ones(n_quads),
                      "geom.quad_flip": np.zeros(n_quads, bool),
                      "geom.quad_pack": np.zeros((n_quads, 34))})
        if moving:
            a["geom.tri_dv0"] = a["geom.tri_de1"] = a["geom.tri_de2"] = np.zeros((n_tris, 3))
        return bridge.from_arrays(a, "geom", "cpu")

    def route(acc):
        return ("wide" if acc.wide is not None else "bvh" if acc.bvh is not None
                else "flat" if acc.tri_soa is not None else "scan")

    assert route(t_bvh.make_accel(geom(8192, 0))) == "wide"
    assert route(t_bvh.make_accel(geom(8192, 0, moving=True))) == "scan"
    assert route(t_bvh.make_accel(geom(8191, 0))) == "flat"
    assert route(t_bvh.make_accel(geom(8191, 0), force="flat")) == "flat"
    assert route(t_bvh.make_accel(geom(8192, 0), force="flat")) == "flat"
    assert route(t_bvh.make_accel(geom(100, 0), force="bvh")) == "bvh"
    assert route(t_bvh.make_accel(geom(100, 0, moving=True))) == "scan"
    assert route(t_bvh.make_accel(geom(100, 0), force="wide")) == "wide"
    big = geom(100, 32769)
    assert route(t_bvh.make_accel(big)) == "bvh"
    assert route(t_bvh.make_accel(big, force="flat")) == "flat"
    assert route(t_bvh.make_accel(geom(100, 32668))) == "flat"


HEAD = """
Film "image" "integer xresolution" [48] "integer yresolution" [32]
Sampler "stratified" "integer xsamples" [3] "integer ysamples" [3]
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
    "float shutteropen" [0] "float shutterclose" [1]
TransformTimes 0 1
"""

BODY = """
SurfaceIntegrator "directlighting"
WorldBegin
LightSource "distant" "point from" [0 0 -10] "point to" [0 0 0] "rgb L" [3 3 3]
TransformBegin
  ActiveTransform EndTime
  Translate {dx} 0 0
  ActiveTransform All
  Material "matte" "rgb Kd" [.8 .8 .8]
  Shape "sphere" "float radius" [0.6]
TransformEnd
WorldEnd
"""


def _render(tmp_path, text):
    path = tmp_path / "scene.pbrt"
    path.write_text(textwrap.dedent(text))
    t_api.pbrt_init({"quiet": True, "write": False, "device": "cpu"})
    try:
        t_parser.parse_file(str(path))
        return t_api._state.output
    finally:
        t_api._state.__init__()


def test_motion_blur_smears_sphere(tmp_path):
    """tests/test_motion.py:49 on the port."""
    moving = _render(tmp_path, HEAD + BODY.format(dx=2.0))
    static = _render(tmp_path, HEAD + BODY.format(dx=0.0))
    assert moving.shape == (32, 48, 3)
    assert np.all(np.isfinite(moving))
    lum_s = static.mean(-1).mean(0)
    lum_m = moving.mean(-1).mean(0)
    assert lum_s.max() > 0.01
    cols_s = (lum_s > 1e-4).sum()
    cols_m = (lum_m > 1e-4).sum()
    assert cols_m > cols_s + 3, (cols_s, cols_m)
    right = lum_m[int(0.75 * 48):].sum()
    right_s = lum_s[int(0.75 * 48):].sum()
    assert right > right_s + 1e-4


def test_motion_time_extremes():
    """tests/test_motion.py:69 on the port: rays at time 0 hit the start
    position, rays at time 1 the end."""
    t0 = Transform.translate([0.0, 0.0, 0.0])
    t1 = Transform.translate([3.0, 0.0, 0.0])
    ps = ParamSet()
    ps.add("float", "radius", [1.0])
    srec = ShapeRecord(kind="sphere", params=ps, o2w=t0, w2o=t0.inverse(),
                       reverse_orientation=False, material=None,
                       animated=AnimatedTransform(t0, 0.0, t1, 1.0))
    ro = RenderOptions()
    ro.shapes = [srec]
    scene = t_compile(ro, "cpu")
    assert scene.geom.has_motion
    n = 4
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    times = torch.tensor([0.0, 1.0, 0.0, 1.0])
    for x, expect in ((0.0, [True, False]), (3.0, [False, True])):
        o = torch.tensor([[x, 0.0, -5.0]]).repeat(n, 1)
        hit = scene.intersect(Ray(o, d, torch.zeros(n), torch.full((n,), float("inf")), times))
        assert hit.valid[:2].tolist() == expect
