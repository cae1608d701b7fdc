"""The grid and kd-tree accelerators and the aggregatetest renderer of the
port against the JAX package's on the same inputs.

Builds: the port's grid and kd-tree arrays equal the JAX package's,
array for array (triangles alone, and triangles with quadrics; a
kd-tree asked deeper than its stack is clamped with the same warning).
Traversals: on the JAX package's trees (handed over through bridge.py)
and the rays of tests/test_accel.py, closest and any hit: prim
identical, t within 1e-5 relative (with 5e-5 absolute slack at the
quadrics, as in test_torch_motion.py: XLA contracts the root's
multiply-adds into FMAs); both agree with exhaustion, and tmax is
respected. Renders under "grid" and "kdtree" agree with the same scene
under "bvh" (image mean within 0.5%, 99% of pixels within 1e-3).
aggregatetest counts the same mismatches in both packages on a forced
binary tree, and is vacuous in both where no binary tree is built.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_accel import _random_rays, _random_tri_geom  # noqa: E402
from test_torch_motion import jax_geom_arrays, rays, scene_text  # noqa: E402
from test_torch_slice import _parse, _render  # noqa: E402
from test_torch_slice import scene_text as slice_scene_text  # noqa: E402

from pbrt_tpu.accel import grid as j_grid  # noqa: E402
from pbrt_tpu.accel import kdtree as j_kd  # noqa: E402
from pbrt_tpu.accel.bvh import build_bvh as j_build_bvh  # noqa: E402
from pbrt_tpu.accel.intersect import t_pass_brute as j_t_pass_brute  # noqa: E402
from pbrt_tpu.core.geometry import Ray as JRay  # noqa: E402
from pbrt_tpu.renderers.aggregatetest import run_aggregate_test as j_aggtest  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu.scene.compile import compile_scene as j_compile  # noqa: E402
from pbrt_tpu.scene.paramset import ParamSet as JParamSet  # noqa: E402
from pbrt_tpu_torch import bridge  # noqa: E402
from pbrt_tpu_torch.accel import bvh as t_bvh  # noqa: E402
from pbrt_tpu_torch.accel import grid as t_grid  # noqa: E402
from pbrt_tpu_torch.accel import kdtree as t_kd  # noqa: E402
from pbrt_tpu_torch.accel.intersect import SceneGeom, t_pass_all  # noqa: E402
from pbrt_tpu_torch.core.geometry import Ray  # noqa: E402
from pbrt_tpu_torch.renderers.aggregatetest import run_aggregate_test as t_aggtest  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile  # noqa: E402
from pbrt_tpu_torch.scene.paramset import ParamSet  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def port_tri_geom(jg) -> SceneGeom:
    """The port's geometry of a hand-built JAX triangle soup (no packs:
    the t-passes do not read them)."""
    t = lambda x: torch.as_tensor(np.asarray(x))
    return SceneGeom(tri_v0=t(jg.tri_v0), tri_e1=t(jg.tri_e1), tri_e2=t(jg.tri_e2),
                     tri_n=t(jg.tri_n), tri_has_n=t(jg.tri_has_n), tri_uv=t(jg.tri_uv),
                     tri_mat=t(jg.tri_mat), tri_light=t(jg.tri_light), world_lo=t(jg.world_lo),
                     world_hi=t(jg.world_hi), tri_pack=None)


@pytest.fixture(scope="module")
def geoms(tmp_path_factory):
    """{name: (JAX geometry, port geometry, JAX rays, port rays)}: the
    300-triangle soup of tests/test_accel.py with its rays, and the
    static scene of test_torch_motion.py (tessellated spheres, an
    instanced quad, a floor, a sphere, a cylinder and a disk) with its
    rays (axis-aligned, short and dead ones among them)."""
    jg = _random_tri_geom(300)
    jr = _random_rays(512)
    tr = Ray(*(torch.as_tensor(np.asarray(x)) for x in jr))
    path = tmp_path_factory.mktemp("accel") / "scene.pbrt"
    path.write_text(scene_text(False))
    js = j_compile(_parse(j_api, j_parser, path))
    geom = bridge.from_arrays(jax_geom_arrays(js), "geom", "cpu")
    r = rays(n=1500, seed=4)
    r = r[:4] + (np.zeros_like(r[4]),)
    return {"soup": (jg, port_tri_geom(jg), jr, tr),
            "quadrics": (js.geom, geom, JRay(*(jnp.asarray(x) for x in r)),
                         Ray(*(torch.as_tensor(x) for x in r)))}


def check_t(tt, pt, tj, pj, what, min_hits=30):
    np.testing.assert_array_equal(pt, pj, err_msg=f"{what}: prim")
    hit = pj >= 0
    assert hit.sum() >= min_hits, what
    np.testing.assert_allclose(tt[hit], tj[hit], rtol=1e-5, atol=5e-5, err_msg=f"{what}: t")
    assert np.all(tt[~hit] == 1e30), what


@pytest.mark.parametrize("name", ["soup", "quadrics"])
def test_grid_build_matches_jax(geoms, name):
    jg, tg, _, _ = geoms[name]
    ref = j_grid.build_grid(jg)
    got = t_grid.build_grid_arrays(*t_bvh.prim_bounds(tg))
    for f in j_grid.Grid._fields:
        a, b = got[f], np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got["voxel_prims"]) > tg.n_tris + tg.n_quads


@pytest.mark.parametrize("name,kw", [("soup", {}), ("quadrics", {}),
                                     ("soup", {"max_depth": 80, "max_prims": 2})],
                         ids=["soup", "quadrics", "clamped"])
def test_kdtree_build_matches_jax(geoms, name, kw, capsys, monkeypatch):
    from pbrt_tpu.core import error as j_error
    from pbrt_tpu_torch.core import error as t_error

    monkeypatch.setattr(j_error, "quiet", False)
    monkeypatch.setattr(t_error, "quiet", False)
    jg, tg, _, _ = geoms[name]
    ref = j_kd.build_kdtree(jg, **kw)
    j_err = capsys.readouterr().err
    got = t_kd.build_kdtree_arrays(*t_bvh.prim_bounds(tg), **kw)
    t_err = capsys.readouterr().err
    for f in j_kd.KdTree._fields:
        a, b = got[f], np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert len(got["node_meta"]) > 50
    clamp = "kdtree maxdepth 80 clamped to traversal stack depth 64"
    assert (clamp in j_err) == (clamp in t_err) == ("max_depth" in kw)


def _bridged(kind, jg):
    """The JAX package's tree for jg and the same tree bridged to the port."""
    if kind == "grid":
        ref = j_grid.build_grid(jg)
    else:
        ref = j_kd.build_kdtree(jg)
    part = "grid" if kind == "grid" else "kd"
    return ref, bridge.from_arrays({f"{part}.{f}": np.asarray(getattr(ref, f))
                                    for f in ref._fields}, part, "cpu")


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any"])
@pytest.mark.parametrize("name", ["soup", "quadrics"])
@pytest.mark.parametrize("kind", ["grid", "kdtree"])
def test_traversal_matches_jax(geoms, kind, name, any_hit):
    """The port's walk on the JAX package's tree against the JAX walk:
    closest hit prim identical and t within 1e-5 relative, both equal to
    exhaustion; any hit: the same hit mask as exhaustion."""
    jg, tg, jr, tr = geoms[name]
    ref, tree = _bridged(kind, jg)
    j_walk = j_grid.t_pass_grid if kind == "grid" else j_kd.t_pass_kdtree
    t_walk = t_grid.t_pass_grid if kind == "grid" else t_kd.t_pass_kdtree
    tj, pj = (np.asarray(x) for x in j_walk(ref, jg, jr, any_hit=any_hit))
    tt, pt = (x.numpy() for x in t_walk(tree, tg, tr, any_hit=any_hit))
    tb, pb = (x.numpy() for x in t_pass_all(tg, tr))
    if any_hit:
        np.testing.assert_array_equal(pt >= 0, pb >= 0)
        np.testing.assert_array_equal(pj >= 0, pb >= 0)
    else:
        check_t(tt, pt, tj, pj, f"{kind} vs JAX")
        check_t(tt, pt, tb, pb, f"{kind} vs exhaustion")


@pytest.mark.parametrize("kind", ["grid", "kdtree"])
def test_tmax_respected(geoms, kind):
    """tmax clipped below every first hit (half of it): everything
    misses, as tests/test_accel.py asks of the JAX package's walks
    (here with quadrics among the prims)."""
    jg, tg, _, tr = geoms["quadrics"]
    t_ref, p_ref = t_pass_all(tg, tr)
    assert (p_ref >= 0).sum() > 500
    short = torch.where(p_ref >= 0, t_ref * 0.5, tr.tmax)
    _, tree = _bridged(kind, jg)
    walk = t_grid.t_pass_grid if kind == "grid" else t_kd.t_pass_kdtree
    _, p = walk(tree, tg, Ray(tr.o, tr.d, tr.tmin, short, tr.time))
    assert not bool((p >= 0).any())


def test_make_kdtree_accel_reads_its_parameters(geoms):
    """intersectcost, traversalcost, emptybonus, maxprims and maxdepth
    reach the build (the tree equals the JAX package's factory's), and
    the scene's intersect agrees with exhaustion."""
    jg, tg, jr, tr = geoms["soup"]
    values = {"intersectcost": ("integer", 40), "traversalcost": ("integer", 2),
              "emptybonus": ("float", 0.25), "maxprims": ("integer", 3),
              "maxdepth": ("integer", 12)}
    ps, jps = ParamSet(), JParamSet()
    for k, (ty, v) in values.items():
        ps.add(ty, k, [v])
        jps.add(ty, k, [v])
    accel = t_kd.make_kdtree_accel(tg, ps)
    ref = j_kd.make_kdtree_accel(jg, jps).kd
    for f in j_kd.KdTree._fields:
        np.testing.assert_array_equal(getattr(accel.kd, f).numpy(), np.asarray(getattr(ref, f)))
    default = t_kd.make_kdtree_accel(tg)
    assert len(default.kd.node_meta) != len(accel.kd.node_meta)
    assert accel.wide is None and accel.bvh is None and accel.tri_soa is None
    _, p_ref = t_pass_all(tg, tr)
    np.testing.assert_array_equal(accel.intersect_p(tr).numpy(), p_ref.numpy() >= 0)


@pytest.mark.parametrize("scene_cls", [t_grid.GridScene, t_kd.KdScene])
def test_no_tree_fallback_folds_quadrics(geoms, scene_cls):
    """Without a tree the scene intersects by exhaustion with the
    quadrics folded in: the JAX package's t_pass_brute, prim for prim."""
    jg, tg, jr, tr = geoms["quadrics"]
    acc = scene_cls(tg, None)
    tt, pt = (x.numpy() for x in acc._t_pass(tr))
    tj, pj = (np.asarray(x) for x in j_t_pass_brute(jg, jr))
    assert (pj >= tg.n_tris).sum() > 20   # quadric hits among them
    check_t(tt, pt, tj, pj, "fallback")
    hit = acc.intersect_p(tr)
    np.testing.assert_array_equal(hit.numpy(), pj >= 0)


@pytest.mark.parametrize("accel", ["grid", "kdtree"])
def test_render_under_grid_and_kdtree_matches_bvh(tmp_path, accel):
    """The 32 x 32 slice scene (4 spp, path maxdepth 3) under the grid
    or the kd-tree renders the image it renders under "bvh": mean within
    0.5%, 99% of pixels within 1e-3 relative (a tie broken the other way
    at a shared edge may move a sample); the walks run."""
    text = slice_scene_text()
    base = tmp_path / "bvh.pbrt"
    base.write_text(text)
    other = tmp_path / f"{accel}.pbrt"
    other.write_text(text.replace("WorldBegin", f'Accelerator "{accel}"\nWorldBegin'))
    walk = t_grid.walk_stats if accel == "grid" else t_kd.walk_stats
    walk.update(traversals=0, iterations=0)
    ref = _render(t_api, t_parser, base)
    got = _render(t_api, t_parser, other)
    assert walk["traversals"] > 3
    assert ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


@pytest.fixture(scope="module")
def forced(tmp_path_factory):
    """The static motion-test scene compiled by both packages, each given
    the binary tree (JAX's build_bvh; the port's make_accel(force="bvh"),
    the same tree)."""
    path = tmp_path_factory.mktemp("agg") / "scene.pbrt"
    path.write_text(scene_text(False))
    jro = _parse(j_api, j_parser, path)
    js = j_compile(jro)
    js.accel = js.accel._replace(bvh=j_build_bvh(js.geom, "sah"))
    tro = _parse(t_api, t_parser, path)
    ts = t_compile(tro, "cpu")
    ts.accel = t_bvh.make_accel(ts.geom, force="bvh")
    for f in t_bvh.BVH._fields:
        np.testing.assert_array_equal(getattr(ts.accel.bvh, f).numpy(),
                                      np.asarray(getattr(js.accel.bvh, f)))
    return jro, js, tro, ts


def test_aggregatetest_counts_match_jax(forced):
    """On a forced binary tree both packages count 0 mismatches; with one
    leaf's box shrunk to a point (the same leaf in both), both count the
    same non-zero number."""
    jro, js, tro, ts = forced
    assert j_aggtest(js, jro, n_iters=4096) == 0
    assert t_aggtest(ts, tro, n_iters=4096) == 0
    # the leaf holding the primitive of the largest box (the floor or the disk)
    lo_p, hi_p = t_bvh.prim_bounds(ts.geom)
    big = int(np.argmax(np.prod(np.maximum(hi_p - lo_p, 1e-3), -1)))
    meta = ts.accel.bvh.node_meta.numpy()
    pos = int(np.nonzero(ts.accel.bvh.prim_ids.numpy() == big)[0][0])
    leaf = int(np.nonzero((meta[:, 1] > 0) & (meta[:, 0] <= pos)
                          & (pos < meta[:, 0] + meta[:, 1]))[0][0])
    lo = ts.accel.bvh.node_lo.clone()
    hi = ts.accel.bvh.node_hi.clone()
    mid = 0.5 * (lo[leaf] + hi[leaf])
    lo[leaf], hi[leaf] = mid, mid
    ts.accel = ts.accel._replace(bvh=ts.accel.bvh._replace(node_lo=lo, node_hi=hi))
    js.accel = js.accel._replace(bvh=js.accel.bvh._replace(node_lo=jnp.asarray(lo.numpy()),
                                                           node_hi=jnp.asarray(hi.numpy())))
    n_j = j_aggtest(js, jro, n_iters=4096)
    n_t = t_aggtest(ts, tro, n_iters=4096)
    assert n_t == n_j > 0


HEIGHTFIELD = """Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
LookAt 0 1 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
Renderer "aggregatetest" "integer niters" [2000]
WorldBegin
LightSource "point" "point from" [0 3 -2] "rgb I" [25 25 25]
Material "matte"
Shape "heightfield" "integer nu" [10] "integer nv" [10] "float Pz" [{pz}]
WorldEnd
"""


def test_aggregatetest_is_vacuous_without_a_binary_tree(tmp_path, capsys, monkeypatch):
    """tests/test_integrators.py's heightfield (162 triangles) gets no
    binary tree in either package, so both report 0 without tracing a
    ray, and the port logs the JAX package's info line."""
    from pbrt_tpu_torch.core import error as t_error
    from pbrt_tpu_torch.renderers import aggregatetest

    pz = " ".join(("0 .2 " * 5) if r % 2 == 0 else (".2 0 " * 5) for r in range(10))
    path = tmp_path / "hf.pbrt"
    path.write_text(HEIGHTFIELD.format(pz=pz))
    assert _render(j_api, j_parser, path, {"quick": True}) == 0
    monkeypatch.setattr(t_error, "verbose", True)
    t_api.pbrt_init({"write": False, "device": "cpu", "quick": True, "verbose": True})
    try:
        t_parser.parse_file(str(path))
        out = t_api._state.output
    finally:
        t_api._state.__init__()
    assert out == 0
    assert aggregatetest.last_stats == {"rays": 0, "batches": 0, "mismatches": 0}
    assert "aggregatetest: no BVH built (tiny scene); brute force is the accel" in \
        capsys.readouterr().err
