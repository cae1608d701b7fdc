"""The port's quadrics against the JAX package.

One scene holds each of the six quadric types with partial phi, z and
inner-radius clips, transforms that scale, rotate and flip handedness,
a reverse orientation, two identical spheres (a tie among quadrics), a
disk coplanar with a triangle (a tie between them), a tessellated disk
area light, a full-sphere area light (cone sampling) and a point light.
Both packages compile it; the JAX arrays, handed over by bridge.py, feed
both packages' functions. Rays come from a seed with NumPy and include
rays from a sphere's centre (B = 0), zero directions, dead rays
(tmax = -1) and a short tmax.

Limits: prim identical and t within 1e-5 relative (XLA contracts FMAs,
ATen does not, so t differs by a few ulp). A lane may differ in whether
it hits only where the hit is grazing: the discriminant, or the hit
point's distance to a clip boundary (z range, phimax, disk radii) or to
tmin/tmax, is under 1e-4 of its scale; the tests identify and count
those lanes. Reconstructed geometry: 1e-4 absolute on positions,
normals and dpdu (a few ulp of values of order 1-10), 1e-3 on uv (the
sphere's v goes through acos, whose slope is unbounded at the poles).
Light samples and pdfs: 1e-4 relative (the cone pdf 1 / (1 - cos)
amplifies last-bit differences of |p - centre|^2, whose sums run in
another order). tessellate_quadric and the compiled arrays match
exactly.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from pbrt_tpu.accel import intersect as j_int
from pbrt_tpu.core import sampling as j_samp
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.lights import lighting as j_light
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.shapes import registry as j_shapes
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.accel import intersect as t_int
from pbrt_tpu_torch.accel.bvh import make_accel
from pbrt_tpu_torch.core import sampling as t_samp
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.lights import lighting as t_light
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from pbrt_tpu_torch.shapes import registry as t_shapes
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

GRAZE = 1e-4

SCENE = """Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "point" "point from" [2 6 -5] "rgb I" [20 20 20]
Material "matte" "rgb Kd" [.5 .5 .5]
AttributeBegin
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  Translate 3 0 0  Rotate 30 0 1 0
  Material "plastic" "rgb Kd" [.2 .3 .6]
  Shape "sphere" "float radius" [0.8] "float zmin" [-0.5] "float zmax" [0.6] "float phimax" [270]
AttributeEnd
AttributeBegin
  Translate -3 0 0  Rotate 70 1 0 0  Scale 1 1.5 1
  Shape "cylinder" "float radius" [0.7] "float zmin" [-1] "float zmax" [0.8] "float phimax" [300]
AttributeEnd
AttributeBegin
  Translate 0 3 0  Rotate 90 1 0 0
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Shape "disk" "float radius" [1.2] "float innerradius" [0.3] "float phimax" [320]
AttributeEnd
AttributeBegin
  Translate 0 -3 0  Scale 1 -1 1
  Shape "cone" "float radius" [0.9] "float height" [1.5] "float phimax" [200]
AttributeEnd
AttributeBegin
  Translate 3 3 0  ReverseOrientation
  Shape "paraboloid" "float radius" [0.8] "float zmin" [0.2] "float zmax" [1.2] "float phimax" [330]
AttributeEnd
AttributeBegin
  Translate -3 3 0  Rotate -40 0 0 1
  Shape "hyperboloid" "point p1" [0.5 0 -0.8] "point p2" [0.3 0.6 0.8] "float phimax" [340]
AttributeEnd
AttributeBegin
  Translate 0 0 4
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  Translate 0 0 4
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  Translate 3 -3 0
  AreaLightSource "diffuse" "rgb L" [2 2 2]
  Shape "sphere" "float radius" [0.5]
AttributeEnd
AttributeBegin
  Translate 0 0 -4
  Shape "disk" "float radius" [2]
AttributeEnd
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-2 -2 -4  2 -2 -4  -2 2 -4  -5 -5 -5.5]
WorldEnd
"""

CENTRES = np.array([[0, 0, 0], [3, 0, 0], [-3, 0, 0], [0, 3, 0], [0, -3, 0], [3, 3, 0],
                    [-3, 3, 0], [0, 0, 4], [3, -3, 0], [0, 0, -4]], np.float32)


def arrays_of(js):
    """The JAX compiled scene as bridge arrays."""
    out = {f"geom.{f}": np.asarray(getattr(js.geom, f)) for f in bridge.GEOM_FIELDS}
    out.update({f"lights.{f}": np.asarray(getattr(js.lights, f)) for f in bridge.LIGHT_FIELDS})
    out.update({f"light_dist.{f}": np.asarray(getattr(js.light_dist, f))
                for f in bridge.DIST_FIELDS})
    if js.volume is not None:
        out.update({f"volume.{f}": np.asarray(getattr(js.volume, f))
                    for f in bridge.VOLUME_FIELDS})
    return out


def assert_compile_parity(js, ts):
    """The port's compile equals the JAX compile array for array (the
    light-pick CDF, a float32 cumsum in another order, within 1e-6)."""
    ref = arrays_of(js)
    got = bridge.scene_to_arrays(ts)
    got = {k: v for k, v in got.items() if not k.startswith("wide.")}
    assert set(got) == set(ref)
    for key in sorted(ref):
        if key.startswith("light_dist."):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], ref[key].astype(got[key].dtype), err_msg=key)
    return ref


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = tmp_path_factory.mktemp("quadrics") / "scene.pbrt"
    path.write_text(SCENE)
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    ref = assert_compile_parity(js, ts)
    geom = bridge.from_arrays(ref, "geom", "cpu")
    return js, ts, geom, ref


def make_rays(seed=0, n=6144):
    """NumPy rays: random, aimed at the quadrics, from the first sphere's
    centre, the coplanar-tie rays, zero directions, dead and short."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-6, 6, (n, 3))
    d = rng.normal(size=(n, 3))
    aim = rng.rand(n) < 0.6
    target = CENTRES[rng.randint(0, len(CENTRES), n)] + rng.normal(0, 0.5, (n, 3))
    d[aim] = target[aim] - o[aim]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o[:256] = 0.0                                   # from the sphere's centre: B = 0
    xy = rng.choice([-1.75, -1.5, -1.0, -0.5, -0.25, 0.0], (64, 2))
    o[256:320] = np.concatenate([xy, np.full((64, 1), -6.0)], -1)   # coplanar tie, t = 2
    d[256:320] = [0.0, 0.0, 1.0]
    d[320:352] = 0.0                                # zero directions
    tmin = np.zeros(n)
    tmax = np.full(n, np.inf)
    tmax[352:608] = -1.0                            # dead
    tmax[608:864] = rng.uniform(0.5, 3.0, 256)      # short
    f32 = [x.astype(np.float32) for x in (o, d, tmin, tmax)]
    return f32 + [np.zeros(n, np.float32)]


def jray(r):
    return JRay(*(np.asarray(x) for x in r))


def tray(r):
    return Ray(*(torch.as_tensor(x) for x in r))


def grazing(qtype, params, o, d, tmin, tmax):
    """[...] bool: a hit of this (ray, quadric) pair lies within GRAZE of
    a decision boundary, in float64 (the inputs of _quad_candidates)."""
    o, d, params = (np.asarray(x, np.float64) for x in (o, d, params))
    r, zmin, zmax, phimax, p4, p5 = (params[..., i] for i in range(6))
    ox, oy, oz = (o[..., i] for i in range(3))
    dx, dy, dz = (d[..., i] for i in range(3))
    kc = (r / np.maximum(p4, 1e-12)) ** 2
    kp = p4 / np.maximum(r * r, 1e-12)
    A = np.select([qtype == 0, qtype == 1, qtype == 3, qtype == 4, qtype == 5],
                  [dx * dx + dy * dy + dz * dz, dx * dx + dy * dy,
                   dx * dx + dy * dy - kc * dz * dz, kp * (dx * dx + dy * dy),
                   p4 * (dx * dx + dy * dy) - p5 * dz * dz], 0.0)
    B = np.select([qtype == 0, qtype == 1, qtype == 3, qtype == 4, qtype == 5],
                  [2 * (ox * dx + oy * dy + oz * dz), 2 * (ox * dx + oy * dy),
                   2 * (ox * dx + oy * dy - kc * dz * (oz - p4)),
                   2 * kp * (ox * dx + oy * dy) - dz,
                   2 * (p4 * (ox * dx + oy * dy) - p5 * oz * dz)], 0.0)
    C = np.select([qtype == 0, qtype == 1, qtype == 3, qtype == 4, qtype == 5],
                  [ox * ox + oy * oy + oz * oz - r * r, ox * ox + oy * oy - r * r,
                   ox * ox + oy * oy - kc * (oz - p4) ** 2, kp * (ox * ox + oy * oy) - oz,
                   p4 * (ox * ox + oy * oy) - p5 * oz * oz - 1.0], 0.0)
    disc = B * B - 4 * A * C
    near = np.abs(disc) <= GRAZE * np.maximum(B * B + np.abs(4 * A * C), 1e-30)
    near |= np.abs(A) <= 1e-6      # near the linear case's switch
    sq = np.sqrt(np.maximum(disc, 0.0))
    roots = [(-B - sq) / np.where(A == 0, 1, 2 * A), (-B + sq) / np.where(A == 0, 1, 2 * A),
             (zmin - oz) / np.where(dz == 0, 1, dz)]
    scale = np.maximum(np.abs(zmax - zmin) + r, 1e-6)
    for t in roots:
        x, y, z = ox + t * dx, oy + t * dy, oz + t * dz
        phi = np.mod(np.arctan2(y, x), 2 * np.pi)
        d2 = x * x + y * y
        near |= np.minimum(np.abs(z - zmin), np.abs(z - zmax)) <= GRAZE * scale
        near |= np.abs(phi - phimax) <= GRAZE * 2 * np.pi
        near |= np.minimum(phi, 2 * np.pi - phi) <= GRAZE * 2 * np.pi
        near |= np.abs(d2 - r * r) <= GRAZE * np.maximum(r * r, 1e-6)
        near |= (qtype == 2) & (np.abs(d2 - p4 * p4) <= GRAZE * np.maximum(r * r, 1e-6))
        near |= np.abs(t - tmin) <= GRAZE * np.maximum(np.abs(t), 1.0)
        near |= np.abs(t - tmax) <= GRAZE * np.maximum(np.abs(t), 1.0)
    return near


def object_space(geom_arrays, o, d):
    """World rays -> every quadric's object space, float32 [R, Q, 3]."""
    w2o = geom_arrays["geom.quad_w2o"]
    oo = np.einsum("qij,rj->rqi", w2o[:, :3, :3], o) + w2o[None, :, :3, 3]
    dd = np.einsum("qij,rj->rqi", w2o[:, :3, :3], d)
    return oo.astype(np.float32), dd.astype(np.float32)


def test_quad_candidates_match_jax_for_every_type(scene):
    _, _, geom, ref = scene
    o, d, tmin, tmax, _ = make_rays(1)
    oo, dd = object_space(ref, o, d)
    qt, qp = ref["geom.quad_type"], ref["geom.quad_params"]
    assert set(qt.tolist()) == set(range(6))
    args = (qt[None], qp[None], oo, dd, tmin[:, None], tmax[:, None])
    tj, vj = (np.asarray(x) for x in j_int._quad_candidates(*args, present=set(qt.tolist())))
    tt, vt = (x.numpy() for x in t_int.quad_candidates(
        *(torch.as_tensor(np.array(a)) for a in args), present=geom.quad_present))
    both = vj & vt
    differ = (vj != vt) | (both & (np.abs(tt - tj) > 1e-5 * np.abs(tj)))
    graze = grazing(qt[None], qp[None], oo, dd, tmin[:, None], tmax[:, None])
    assert not (differ & ~graze).any(), np.argwhere(differ & ~graze)[:5]
    assert differ.sum() <= 1e-3 * differ.size, int(differ.sum())
    for k in range(6):
        assert both[:, qt == k].sum() > 50, k    # every type is hit, clipped as it is
    assert not np.isnan(tt).any()
    assert not vt[320:352].any() and not vt[352:608].any()   # zero directions, dead rays
    print(f"grazing lanes that differ: {int(differ.sum())} of {differ.size}")


def test_quad_t_pass_and_reconstruct_match_jax(scene):
    """The fold over all quadrics (after the triangles' plain t-pass) and
    the quadric half of the reconstruct."""
    js, _, geom, ref = scene
    rays = make_rays(2)
    o, d, tmin, tmax, _ = rays
    t_tri, p_tri = t_int.t_pass_brute(geom, tray(rays))
    tj, pj = (np.asarray(x) for x in j_int._quad_t_pass(js.geom, jray(rays), t_tri.numpy(),
                                                          p_tri.numpy().astype(np.int32)))
    tt, pt = t_int.quad_t_pass(geom, tray(rays), t_tri, p_tri)
    tt, pt = tt.numpy(), pt.numpy()
    T = geom.n_tris
    differ = (pt != pj) | ((pj >= 0) & (np.abs(tt - tj) > 1e-5 * np.abs(tj)))
    oo, dd = object_space(ref, o, d)
    graze = grazing(ref["geom.quad_type"][None], ref["geom.quad_params"][None], oo, dd,
                    tmin[:, None], tmax[:, None]).any(-1)
    assert not (differ & ~graze).any(), np.argwhere(differ & ~graze)[:5]
    assert differ.sum() <= 2e-3 * len(pt), int(differ.sum())
    assert (pt >= T).sum() > 1000 and (pt[pt >= 0] < T + geom.n_quads).all()
    assert (pt[352:608] == -1).all() and (tt[352:608] == 1e30).all()   # dead rays miss
    assert (pt[320:352] == -1).all()
    # the coplanar disk ties with the triangle at t = 2: the triangle keeps it
    assert (pt[256:320] < T).all() and (tt[256:320] == 2.0).all()
    # two identical spheres: the first one wins
    q7, q8 = T + 7, T + 8
    assert (pt == q7).sum() > 20 and not (pt == q8).any()
    assert np.isfinite(tt).all()

    same = ~differ
    quad = same & (pj >= T)
    assert quad.sum() > 1000
    # the packed rows of compiled scenes, and the per-field tables of
    # geometries built without them
    for jg, tg in ((js.geom, geom), (js.geom._replace(quad_pack=None),
                                     geom._replace(quad_pack=None))):
        hj = j_int.reconstruct(jg, jray(rays), tj, pj)
        ht = t_int.reconstruct(tg, tray(rays), torch.as_tensor(tj), torch.as_tensor(pj).long())
        for f, tol in (("p", 1e-4), ("ng", 1e-4), ("ns", 1e-4), ("dpdu", 1e-4), ("uv", 1e-3)):
            a, b = getattr(ht, f).numpy()[same], np.asarray(getattr(hj, f))[same]
            np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(1.0, np.abs(b).max() / 10),
                                       err_msg=f)
        for f in ("valid", "mat", "light", "prim"):
            np.testing.assert_array_equal(getattr(ht, f).numpy(), np.asarray(getattr(hj, f)),
                                          err_msg=f)


def test_flat_scene_t_pass_folds_quadrics_like_jax(scene):
    """BvhScene's t-pass on the CPU (K1's plain twin, then the quadric
    fold) against the JAX package's t_pass_brute, closest and any hit."""
    js, _, geom, ref = scene
    rays = make_rays(3)
    accel = make_accel(geom)
    assert accel.tri_soa is not None and accel.wide is None
    tt, pt = (x.numpy() for x in accel._t_pass(tray(rays)))
    tj, pj = (np.asarray(x) for x in j_int.t_pass_brute(js.geom, jray(rays)))
    o, d, tmin, tmax, _ = rays
    oo, dd = object_space(ref, o, d)
    graze = grazing(ref["geom.quad_type"][None], ref["geom.quad_params"][None], oo, dd,
                    tmin[:, None], tmax[:, None]).any(-1)
    differ = (pt != pj) | ((pj >= 0) & (np.abs(tt - tj) > 1e-5 * np.abs(tj)))
    assert not (differ & ~graze).any()
    hit_p = accel.intersect_p(tray(rays)).numpy()
    assert ((hit_p != (pj >= 0)) <= graze).all()


def test_quadric_only_scene_runs_no_triangle_t_pass(tmp_path, monkeypatch):
    """A scene without triangles folds its quadrics into empty
    accumulators: no triangle t-pass (K1 or its plain twin) runs."""
    from pbrt_tpu_torch.ops import intersect_cuda

    def refuse(*args):
        raise AssertionError("a triangle t-pass ran in a quadric-only scene")

    monkeypatch.setattr(intersect_cuda, "tri_t_pass_plain", refuse)
    monkeypatch.setattr(intersect_cuda, "tri_t_pass_cuda", refuse)
    monkeypatch.setattr(t_int, "t_pass_brute", refuse)
    path = tmp_path / "q.pbrt"
    path.write_text('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
                    'Sampler "random" "integer pixelsamples" [1]\n'
                    'LookAt 0 0 -5  0 0 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
                    'WorldBegin\nLightSource "point" "point from" [2 4 -4] "rgb I" [20 20 20]\n'
                    'Shape "sphere" "float radius" [1]\nWorldEnd\n')
    t_api.pbrt_init({"quiet": True, "write": False, "device": "cpu"})
    try:
        t_parser.parse_file(str(path))
        img = np.asarray(t_api._state.output)
    finally:
        t_api._state.__init__()
    assert img.mean() > 0 and np.isfinite(img).all()


def _quadric_data(pkg, q):
    return pkg.QuadricData(q.qtype, q.o2w, q.w2o, q.params, q.reverse_orientation,
                           q.swaps_handedness)


@pytest.mark.parametrize("qtype", range(6))
def test_tessellate_quadric_matches_jax_exactly(qtype, tmp_path):
    """Emitter triangles of each type, with clips, under a transform that
    swaps handedness and with reverse orientation."""
    from pbrt_tpu_torch.core.transform import Transform as TT
    from pbrt_tpu_torch.scene.paramset import ParamSet

    shapes = {
        0: ("sphere", [("float", "radius", [0.8]), ("float", "zmin", [-0.3]),
                       ("float", "phimax", [250.0])]),
        1: ("cylinder", [("float", "radius", [0.7]), ("float", "zmax", [0.5])]),
        2: ("disk", [("float", "radius", [1.2]), ("float", "innerradius", [0.4]),
                     ("float", "height", [0.25]), ("float", "phimax", [300.0])]),
        3: ("cone", [("float", "radius", [0.9]), ("float", "height", [1.5])]),
        4: ("paraboloid", [("float", "radius", [0.8]), ("float", "zmin", [0.2])]),
        5: ("hyperboloid", [("point", "p1", [0.5, 0.0, -0.8]),
                            ("point", "p2", [0.3, 0.6, 0.8])]),
    }
    name, plist = shapes[qtype]
    params = ParamSet()
    for ty, key, val in plist:
        params.add(ty, key, val)
    o2w = TT.translate([1, 2, 3]) * TT.rotate(35, [1, 1, 0]) * TT.scale(1, -1, 1.5)
    sd = t_shapes.make_shape(name, params, o2w, o2w.inverse(), qtype % 2 == 0)
    (q,) = sd.quadrics
    assert q.qtype == qtype and q.swaps_handedness
    got = t_shapes.tessellate_quadric(q)
    ref = j_shapes.tessellate_quadric(_quadric_data(j_shapes, q))
    assert len(got[0]) > 100
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_make_shape_matches_jax(scene):
    """Every quadric record of the scene, field for field (through the
    compiled arrays) — and a hyperboloid through both factories."""
    from pbrt_tpu.core.transform import Transform as JT
    from pbrt_tpu.scene.paramset import ParamSet as JP
    from pbrt_tpu_torch.core.transform import Transform as TT
    from pbrt_tpu_torch.scene.paramset import ParamSet as TP

    got, ref = [], []
    for pkg, P, X, out in ((t_shapes, TP, TT, got), (j_shapes, JP, JT, ref)):
        params = P()
        params.add("point", "p1", [0.2, 0.1, 0.0])
        params.add("point", "p2", [0.6, 0.0, 1.0])
        params.add("float", "phimax", [400.0])
        m = X.rotate(20, [0, 0, 1])
        (q,) = pkg.make_shape("hyperboloid", params, m, m.inverse(), False).quadrics
        out.append(q)
    for f in ("qtype", "o2w", "w2o", "params", "reverse_orientation", "swaps_handedness"):
        np.testing.assert_array_equal(getattr(got[0], f), getattr(ref[0], f), err_msg=f)


def test_sphere_and_disk_lights_match_jax(scene):
    """sample_light and light_pdf for the tessellated disk emitter, the
    cone-sampled full sphere (from outside and from inside) and the
    point light, at the same points and uniforms."""
    js, ts, _, ref = scene
    lights = bridge.from_arrays(ref, "lights", "cpu")
    L = int(ref["lights.kind"].shape[0])
    assert L == 3 and ref["lights.params"][:, 1].tolist() == [0.0, 0.0, 1.0]
    rng = np.random.RandomState(4)
    n = 3000
    p = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    p[:200] = (np.array([3, -3, 0]) + rng.uniform(-0.3, 0.3, (200, 3))).astype(np.float32)
    u1, u2 = rng.rand(2, n).astype(np.float32)
    idx = (np.arange(n) % L).astype(np.int32)
    sj = j_light.sample_light(js.lights, js.envs, idx, p, u1, u2)
    st = t_light.sample_light(lights, torch.as_tensor(idx), *(torch.as_tensor(x) for x in (p, u1, u2)))
    for f in ("L", "wi", "pdf", "dist"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(st.is_delta.numpy(), np.asarray(sj.is_delta))
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    pj = np.asarray(j_light.light_pdf(js.lights, js.envs, idx, p, wi))
    pt = t_light.light_pdf(lights, torch.as_tensor(idx), torch.as_tensor(p),
                           torch.as_tensor(wi)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=1e-4)
    assert (pt[idx == 2] > 0).any() and (pt[idx != 2] == 0).all()


def test_area_triangle_pick_equals_masked_pass():
    """The sorted search of _pick_area_tri against the reference's masked
    pass (smallest j in the light's segment with cdf[j] >= x, else the
    segment start), with empty segments, zero-area triangles, x = 0 and
    x equal to CDF values."""
    rng = np.random.RandomState(5)
    counts = np.array([0, 7, 0, 1, 30, 0, 12, 3])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cdf = []
    for c in counts:
        a = rng.rand(c).astype(np.float32) * (rng.rand(c) > 0.2)
        a[0:1] += 0.01
        cdf.append((np.cumsum(a) / a.sum()).astype(np.float32))
    cdf = np.concatenate(cdf).astype(np.float32)
    AT = len(cdf)
    params = np.zeros((len(counts), 12), np.float32)
    params[:, 6], params[:, 7] = starts, counts
    z = torch.zeros((AT, 3))
    lights = t_light.LightsT(None, None, None, None, torch.as_tensor(params), None, None,
                             z, z, z, torch.as_tensor(cdf))
    n = 20000
    li = rng.randint(0, len(counts), n)
    x = rng.rand(n).astype(np.float32)
    x[:2000] = 0.0
    pick = rng.randint(0, AT, 4000)
    x[2000:6000] = cdf[pick]
    x = (x * np.float32(0.9999999)).astype(np.float32)
    j = np.arange(AT)
    in_seg = (j[None] >= starts[li][:, None]) & (j[None] < (starts + counts)[li][:, None])
    passed = in_seg & (cdf[None] >= x[:, None])
    want = np.where(passed.any(-1), passed.argmax(-1), starts[li])
    got = t_light._pick_area_tri(lights, torch.as_tensor(starts[li]),
                                 torch.as_tensor(counts[li]), torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sphere_and_cone_sampling_match_jax():
    rng = np.random.RandomState(6)
    u1, u2 = rng.rand(2, 4096).astype(np.float32)
    cmax = rng.uniform(-0.2, 1.0, 4096).astype(np.float32)
    pairs = [
        (t_samp.uniform_sample_sphere(torch.as_tensor(u1), torch.as_tensor(u2)),
         j_samp.uniform_sample_sphere(u1, u2)),
        (t_samp.uniform_sample_cone(*(torch.as_tensor(x) for x in (u1, u2, cmax))),
         j_samp.uniform_sample_cone(u1, u2, cmax)),
        (t_samp.uniform_cone_pdf(torch.as_tensor(cmax)), j_samp.uniform_cone_pdf(cmax)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6, atol=2e-7)


def test_benchvol_compiles_like_jax(tmp_path):
    """The full-size benchvol scene (135,202 triangles, a glass sphere, a
    disk light, a point light, a homogeneous volume): light rows, quadric
    arrays, triangles and volume identical through the bridge."""
    path = tmp_path / "benchvol.pbrt"
    path.write_text(chip_smoke.benchvol_scene_text(16))
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    ref = assert_compile_parity(js, ts)
    assert ts.geom.n_tris == 135202 and ts.geom.n_quads == 2
    assert ts.accel.wide is not None
    assert ref["lights.kind"].tolist() == [0, 6]            # point, tessellated disk
    assert ref["lights.params"][1, 7] > 1000
    assert math.isclose(float(ref["lights.params"][1, 0]), math.pi, rel_tol=0.01)
