"""The port's substrate helpers against the JAX package's on the same
seeded NumPy inputs: core/geometry.py (vector helpers, Ray.at / make,
RayDifferential, BBox), core/sampling.py (hemisphere warp and pdf, phase
functions, HG sampling, the balance heuristic, the (0,2)-sequence, the
stratified and Latin-hypercube patterns), core/spectrum.py (constant,
intensity_at), core/transform.py (Transform's applies, predicates,
equality and axis rotations; xform_point),
accel/intersect.py (intersect, intersect_p), integrators/surface.py
(li_path_psamples), volumes/registry.py (has_rainbow) and
lights/lighting.py (LightsT.n_lights); then the cases of
tests/test_substrate.py that use these names.

Tolerances: exact where the result is integer or bits (sample02, the
box predicates, has_rainbow, Transform equality, the stratified and
Latin-hypercube draws of keys 0 and 1) and where both packages run the
same operations elementwise (the host matrices, Ray, BBox's min / max /
differences, constant); 1e-6 relative elsewhere (of the largest value
for vectors and spectra): XLA and ATen round sin, cos, sqrt and
divisions apart by an ulp and sum three components in another order.
intersect holds the limits of tests/test_torch_intersect.py and
tests/test_torch_bvh.py: prim identical, t within 1e-5 relative or 1e-6
absolute (a near hit's t rounds on the coordinates' scale), the hit's
geometry within 1e-4 (XLA contracts the jitted t-pass's multiply-adds
into FMAs). li_path_psamples: L within 1e-6 of the largest value
(observed 3e-7).
"""
import os
import sys
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_intersect import jax_geom, random_geom_arrays, random_rays  # noqa: E402
from test_torch_slice import _parse, scene_text  # noqa: E402

from pbrt_tpu.accel import intersect as j_int  # noqa: E402
from pbrt_tpu.core import geometry as j_geo  # noqa: E402
from pbrt_tpu.core import sampling as j_mc  # noqa: E402
from pbrt_tpu.core import spectrum as j_spec  # noqa: E402
from pbrt_tpu.core import transform as j_xf  # noqa: E402
from pbrt_tpu.integrators import surface as j_surface  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu.scene.compile import compile_scene as j_compile  # noqa: E402
from pbrt_tpu.volumes import registry as j_vol  # noqa: E402
from pbrt_tpu_torch import bridge  # noqa: E402
from pbrt_tpu_torch.accel import intersect as t_int  # noqa: E402
from pbrt_tpu_torch.core import geometry as t_geo  # noqa: E402
from pbrt_tpu_torch.core import sampling as t_mc  # noqa: E402
from pbrt_tpu_torch.core import spectrum as t_spec  # noqa: E402
from pbrt_tpu_torch.core import threefry  # noqa: E402
from pbrt_tpu_torch.core import transform as t_xf  # noqa: E402
from pbrt_tpu_torch.integrators import surface as t_surface  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile  # noqa: E402
from pbrt_tpu_torch.volumes import registry as t_vol  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

N = 256


def pair(x):
    """The same NumPy array as a JAX and a torch (CPU) array."""
    return jnp.asarray(x), torch.as_tensor(x)


def close(got, ref, exact=False, vec=False):
    """got (torch) against ref (JAX): bit-equal, or within 1e-6
    relative (of the largest |ref| for vectors)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    if exact:
        np.testing.assert_array_equal(got, ref)
    else:
        atol = 1e-6 * np.abs(ref).max() if vec else 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=atol)


def unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# core/geometry.py

def test_vector_helpers_match_jax():
    rng = np.random.RandomState(0)
    (ja, ta), (jb, tb) = pair(rng.normal(size=(N, 3)).astype(np.float32)), pair(
        rng.normal(size=(N, 3)).astype(np.float32))
    for name in ("absdot", "distance", "distance_sq"):
        close(getattr(t_geo, name)(ta, tb), getattr(j_geo, name)(ja, jb))
    close(t_geo.length_sq(ta), j_geo.length_sq(ja))
    close(t_geo.faceforward(ta, tb), j_geo.faceforward(ja, jb), exact=True)
    (js, ts), (jc, tc), (jp, tp) = (pair(rng.uniform(0, 1, N).astype(np.float32))
                                    for _ in range(3))
    jp, tp = jp * 6.2831855, tp * 6.2831855
    close(t_geo.spherical_direction(ts, tc, tp), j_geo.spherical_direction(js, jc, jp), vec=True)
    (jx, tx), (jy, ty), (jz, tz) = (pair(unit(rng, N)) for _ in range(3))
    close(t_geo.spherical_direction_frame(ts, tc, tp, tx, ty, tz),
          j_geo.spherical_direction_frame(js, jc, jp, jx, jy, jz), vec=True)
    close(t_geo.lerp(ts[:, None], ta, tb), j_geo.lerp(js[:, None], ja, jb), exact=True)


def test_rays_match_jax():
    """Ray.make's broadcast and defaults, Ray.at, RayDifferential.scale."""
    rng = np.random.RandomState(1)
    jo, to = pair(np.float32([0.5, -1.0, 2.0]))
    jd, td = pair(unit(rng, N))
    jt, tt = pair(rng.uniform(0, 5, N).astype(np.float32))
    for kw in ({}, {"tmin": 1e-3, "tmax": 10.0, "time": 0.25}):
        jr, tr = j_geo.Ray.make(jo, jd, **kw), t_geo.Ray.make(to, td, **kw)
        for f in j_geo.Ray._fields:
            close(getattr(tr, f), getattr(jr, f), exact=True)
            assert getattr(tr, f).dtype == torch.float32
    close(tr.at(tt), jr.at(jt), exact=True)
    offs = [pair(rng.normal(size=(N, 3)).astype(np.float32)) for _ in range(4)]
    jrd = j_geo.RayDifferential(jr, *(j for j, _ in offs), jnp.ones(N, bool))
    trd = t_geo.RayDifferential(tr, *(t for _, t in offs), torch.ones(N, dtype=torch.bool))
    jsc, tsc = jrd.scale(0.25), trd.scale(0.25)
    for f in ("rx_o", "rx_d", "ry_o", "ry_d", "has_differentials"):
        close(getattr(tsc, f), getattr(jsc, f), exact=True)


def test_bbox_matches_jax():
    """Every BBox method on boxes some of which are empty (lo > hi)."""
    rng = np.random.RandomState(2)
    lo = rng.uniform(-2, 1, (N, 3)).astype(np.float32)
    hi = lo + rng.uniform(-0.3, 2, (N, 3)).astype(np.float32)
    jb = j_geo.BBox(jnp.asarray(lo), jnp.asarray(hi))
    tb = t_geo.BBox(torch.as_tensor(lo), torch.as_tensor(hi))
    jp, tp = pair(rng.uniform(-2, 3, (N, 3)).astype(np.float32))
    jo, to = pair(rng.uniform(-4, 4, (N, 3)).astype(np.float32))
    d = unit(rng, N)
    d[::7, 1] = 0.0                                   # axis-parallel slabs
    jr, tr = j_geo.Ray.make(jo, jnp.asarray(d)), t_geo.Ray.make(to, torch.as_tensor(d))
    je, te = j_geo.BBox.empty((4,)), t_geo.BBox.empty((4,), device="cpu")
    close(te.lo, je.lo, exact=True)
    close(te.hi, je.hi, exact=True)
    for name, args in (("union_point", ((jp,), (tp,))), ("expand", ((0.1,), (0.1,))),
                       ("union", ((j_geo.BBox(jo, jo + 1.0),), (t_geo.BBox(to, to + 1.0),)))):
        jx, tx = getattr(jb, name)(*args[0]), getattr(tb, name)(*args[1])
        close(tx.lo, jx.lo, exact=True)
        close(tx.hi, jx.hi, exact=True)
    for name in ("diagonal", "surface_area", "centroid"):
        close(getattr(tb, name)(), getattr(jb, name)(), exact=True)
    (jc, jrad), (tc, trad) = jb.bounding_sphere(), tb.bounding_sphere()
    close(tc, jc, exact=True)
    close(trad, jrad)
    assert (trad.numpy() == 0).sum() > 10          # the empty boxes
    inside = tb.inside(tp)
    close(inside, jb.inside(jp), exact=True)
    assert 0 < int(inside.sum()) < N
    (jh, j0, j1), (th, t0, t1) = jb.intersect_p(jr), tb.intersect_p(tr)
    close(th, jh, exact=True)
    assert 0 < int(th.sum()) < N
    close(t0[th], np.asarray(j0)[np.asarray(jh)])
    close(t1[th], np.asarray(j1)[np.asarray(jh)])


def test_bbox_cases_of_test_substrate():
    """tests/test_substrate.py::test_bbox on the port."""
    b = t_geo.BBox(torch.tensor([0.0, 0.0, 0.0]), torch.tensor([1.0, 2.0, 3.0]))
    assert float(b.surface_area()) == pytest.approx(2 * (2 + 3 + 6))
    ray = t_geo.Ray.make(torch.tensor([[-1.0, 0.5, 0.5]]), torch.tensor([[1.0, 0.0, 0.0]]))
    hit, t0, t1 = b.intersect_p(ray)
    assert bool(hit[0])
    assert float(t0[0]) == pytest.approx(1.0)
    assert float(t1[0]) == pytest.approx(2.0)
    miss = t_geo.Ray.make(torch.tensor([[-1.0, 5.0, 0.5]]), torch.tensor([[1.0, 0.0, 0.0]]))
    assert not bool(b.intersect_p(miss)[0][0])


# ---------------------------------------------------------------------------
# core/sampling.py

def test_warps_phases_and_mis_match_jax():
    rng = np.random.RandomState(3)
    (ju1, tu1), (ju2, tu2) = (pair(rng.rand(N).astype(np.float32)) for _ in range(2))
    close(t_mc.uniform_sample_hemisphere(tu1, tu2), j_mc.uniform_sample_hemisphere(ju1, ju2),
          vec=True)
    jc, tc = pair(rng.uniform(-1, 1, N).astype(np.float32))
    close(t_mc.cosine_hemisphere_pdf(tc), j_mc.cosine_hemisphere_pdf(jc))
    assert t_mc.phase_isotropic() == pytest.approx(float(j_mc.phase_isotropic()), rel=1e-7)
    for name in ("phase_rayleigh", "phase_mie_murky"):
        close(getattr(t_mc, name)(tc), getattr(j_mc, name)(jc))
    for g in (-0.7, 0.0, 0.35):
        close(t_mc.phase_schlick(tc, g), j_mc.phase_schlick(jc, g))
    jg, tg = pair(rng.uniform(-0.9, 0.9, N).astype(np.float32))
    close(t_mc.phase_schlick(tc, tg), j_mc.phase_schlick(jc, jg))
    jw, tw = pair(unit(rng, N))
    for g in (0.0, 0.6, -0.4):
        close(t_mc.sample_hg(tw, tu1, tu2, g), j_mc.sample_hg(jw, ju1, ju2, g), vec=True)
    close(t_mc.sample_hg(tw, tu1, tu2, tg), j_mc.sample_hg(jw, ju1, ju2, jg), vec=True)
    (jf, tf), (jq, tq) = (pair(rng.uniform(0, 3, N).astype(np.float32)) for _ in range(2))
    jf, tf = jf.at[:8].set(0.0), torch.where(torch.arange(N) < 8, 0.0, tf)
    close(t_mc.balance_heuristic(1, tf, 2, tq), j_mc.balance_heuristic(1, jf, 2, jq))
    close(t_mc.balance_heuristic(1, tf * 0, 1, tq * 0), j_mc.balance_heuristic(
        1, jf * 0, 1, jq * 0), exact=True)


def test_sample02_matches_jax():
    """The (0,2)-sequence with a 2D scramble, bit for bit."""
    rng = np.random.RandomState(4)
    n = np.arange(4096, dtype=np.uint32)
    sc = rng.randint(0, 2 ** 32, (4096, 2), dtype=np.uint64).astype(np.uint32)
    jx, jy = j_mc.sample02(jnp.asarray(n), jnp.asarray(sc))
    tx, ty = t_mc.sample02(torch.as_tensor(n.astype(np.int64)),
                           torch.as_tensor(sc.astype(np.int64)))
    close(tx, jx, exact=True)
    close(ty, jy, exact=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_stratified_and_latin_hypercube_match_jax(seed):
    """The patterns of jax.random.PRNGKey(seed) and threefry.prng_key(seed),
    bit for bit: jittered and not, and the Latin hypercube, whose
    permutations (one sort round up to 1,625 points, two above) are
    jax.random.permutation's."""
    jk, tk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for jitter in (True, False):
        close(t_mc.stratified_2d(tk, 5, 7, jitter, device="cpu"),
              j_mc.stratified_2d(jk, 5, 7, jitter), exact=True)
        close(t_mc.stratified_1d(tk, 33, jitter, device="cpu"),
              j_mc.stratified_1d(jk, 33, jitter), exact=True)
    for n, dim in ((16, 3), (2000, 2)):
        close(t_mc.latin_hypercube(tk, n, dim, device="cpu"), j_mc.latin_hypercube(jk, n, dim),
              exact=True)
    for n in (1, 2, 1000, 1700):
        close(threefry.permutation(tk, n, "cpu"), jax.random.permutation(jk, n), exact=True)


def test_sampling_cases_of_test_substrate():
    """tests/test_substrate.py::test_sample_hg_matches_pdf and
    ::test_mis_heuristics on the port."""
    w = t_geo.normalize(torch.tensor([[0.3, -0.5, 0.8]])).expand(30000, 3)
    u = threefry.uniform(threefry.prng_key(7), (30000, 2), "cpu")
    wi = t_mc.sample_hg(w, u[:, 0], u[:, 1], 0.6)
    assert float(t_geo.dot(w, wi).mean()) == pytest.approx(0.6, abs=0.01)
    one = torch.tensor(1.0)
    assert float(t_mc.power_heuristic(1, one, 1, one * 0)) == pytest.approx(1.0)
    assert float(t_mc.balance_heuristic(1, one * 0.5, 1, one * 0.5)) == pytest.approx(0.5)


# ---------------------------------------------------------------------------
# core/spectrum.py, core/transform.py

def test_spectrum_helpers_match_jax():
    rng = np.random.RandomState(5)
    close(t_spec.constant(0.3, (4, 2), device="cpu"), j_spec.constant(0.3, (4, 2)), exact=True)
    js, ts = pair(rng.uniform(0, 2, (N, t_spec.N_BINS)).astype(np.float32))
    lam = rng.uniform(380, 720, N).astype(np.float32)
    lam[:3] = (400.0, 700.0, 550.0)
    jl, tl = pair(lam)
    close(t_spec.intensity_at(ts, tl), j_spec.intensity_at(js, jl), vec=True)
    # tests/test_substrate.py::test_intensity_at on the port
    s = torch.as_tensor(np.linspace(1.0, 30.0, t_spec.N_BINS), dtype=torch.float32)
    assert float(t_spec.intensity_at(s[None], torch.tensor([400.0]))[0]) == pytest.approx(
        1.0, abs=1e-4)


def test_transform_helpers_match_jax():
    rng = np.random.RandomState(6)
    j_t = (j_xf.Transform.translate([1, 2, 3]) * j_xf.Transform.rotate(30, [0, 1, 0])
           * j_xf.Transform.scale(2, 2, 2))
    t_t = (t_xf.Transform.translate([1, 2, 3]) * t_xf.Transform.rotate(30, [0, 1, 0])
           * t_xf.Transform.scale(2, 2, 2))
    p = rng.normal(size=(N, 3))
    close(t_t(p), j_t(p), exact=True)
    close(t_t.normal(p), j_t.normal(p), exact=True)
    persp = j_xf.Transform.perspective(45.0, 1e-2, 1000.0)
    t_persp = t_xf.Transform.perspective(45.0, 1e-2, 1000.0)
    close(t_persp(p), persp(p), exact=True)
    close(t_xf.xform_point(torch.as_tensor(t_persp.m), torch.as_tensor(p)),
          j_xf.xform_point(persp.m, p), exact=True)
    for name in ("rotate_x", "rotate_y", "rotate_z"):
        close(getattr(t_xf.Transform, name)(37.0).m, getattr(j_xf.Transform, name)(37.0).m,
              exact=True)
    cases = [(t_xf.Transform(), j_xf.Transform()), (t_t, j_t),
             (t_xf.Transform.rotate_z(90), j_xf.Transform.rotate_z(90)),
             (t_xf.Transform.scale(1, 1, 1.0005), j_xf.Transform.scale(1, 1, 1.0005))]
    for tt, jt in cases:
        assert tt.is_identity() == jt.is_identity()
        assert tt.has_scale() == jt.has_scale()
        for tu, ju in cases:
            assert (tt == tu) == (jt == ju)
            if tt == tu:
                assert hash(tt) == hash(tu)
    assert [t.is_identity() for t, _ in cases] == [True, False, False, False]
    assert [t.has_scale() for t, _ in cases] == [False, True, False, True]
    assert t_xf.Transform.translate([1, 2, 3]) == t_xf.Transform.translate([1, 2, 3])
    assert t_xf.Transform() != t_t and t_xf.Transform() != "identity"
    # tests/test_substrate.py::test_transform_roundtrip on the port
    q = t_t(np.array([1.0, 1.0, 1.0]))
    np.testing.assert_allclose(t_t.inverse()(q), [1.0, 1.0, 1.0], atol=1e-6)
    assert abs(np.dot(t_t.vector([1.0, 0, 0]), t_t.normal([0, 1.0, 0]))) < 1e-6


# ---------------------------------------------------------------------------
# accel/intersect.py, integrators/surface.py, volumes, lights

def test_intersect_matches_jax():
    a = random_geom_arrays(600, seed=1)
    rays = random_rays(2000, seed=2)
    jg = jax_geom(a)
    geom = bridge.from_arrays(a, "geom", "cpu")
    jr = j_geo.Ray(*(jnp.asarray(x) for x in rays), jnp.zeros(len(rays[0])))
    tr = t_geo.Ray(*(torch.as_tensor(x) for x in rays), torch.zeros(len(rays[0])))
    hj, ht = j_int.intersect(jg, jr), t_int.intersect(geom, tr)
    for f in ("valid", "mat", "light", "prim"):
        close(getattr(ht, f), getattr(hj, f), exact=True)
    assert 0.1 < float(ht.valid.float().mean()) < 0.9
    np.testing.assert_allclose(ht.t.numpy(), np.asarray(hj.t), rtol=1e-5, atol=1e-6)
    for f in ("p", "ng", "ns", "uv", "dpdu"):
        np.testing.assert_allclose(getattr(ht, f).numpy(), np.asarray(getattr(hj, f)), rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(np.asarray(getattr(hj, f))).max()),
                                   err_msg=f)
    close(t_int.intersect_p(geom, tr), j_int.intersect_p(jg, jr), exact=True)


@pytest.fixture(scope="module")
def slice_scene(tmp_path_factory):
    """tests/test_torch_slice.py's scene compiled by both packages; the
    port takes the JAX package's light-pick table (bridge.py), as in
    tests/test_torch_metropolis.py."""
    path = tmp_path_factory.mktemp("substrate") / "scene.pbrt"
    path.write_text(scene_text(res=8, spp=1, depth=3))
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    ts.light_dist = bridge.from_arrays({f"light_dist.{f}": np.asarray(getattr(js.light_dist, f))
                                        for f in bridge.DIST_FIELDS}, "light_dist", "cpu")
    return js, ts


def test_li_path_psamples_matches_jax(slice_scene):
    """256 rays from the camera's position into the scene, driven by the
    same primary samples (three bounces of 10 dims, and a short vector
    whose last dim is reused)."""
    js, ts = slice_scene
    assert ts.lights.n_lights == js.lights.n_lights == 2
    rng = np.random.RandomState(8)
    o = np.tile(np.float32([[0.0, 1.5, -5.0]]), (256, 1))
    tgt = rng.uniform([-2.5, -0.2, -1.0], [2.5, 1.5, 1.0], (256, 3)).astype(np.float32)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    jr, tr = j_geo.Ray.make(*(jnp.asarray(x) for x in (o, d))), t_geo.Ray.make(
        *(torch.as_tensor(x) for x in (o, d)))
    for dims in (30, 12):
        u = rng.rand(256, dims).astype(np.float32)
        jL = np.asarray(j_surface.li_path_psamples(js, jr, jnp.asarray(u), max_depth=3))
        tL = t_surface.li_path_psamples(ts, tr, torch.as_tensor(u), max_depth=3).numpy()
        assert (jL.sum(-1) > 0).sum() >= 50
        np.testing.assert_allclose(tL, jL, rtol=1e-6, atol=1e-6 * np.abs(jL).max())


def test_has_rainbow_matches_jax():
    for kinds in ([], ["homogeneous"], ["exponential", "rainbow"], ["rainbow"]):
        recs = [types.SimpleNamespace(kind=k) for k in kinds]
        assert t_vol.has_rainbow(recs) == j_vol.has_rainbow(recs) == ("rainbow" in kinds)
