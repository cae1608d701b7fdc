"""K1 module (flat t-pass) and hit reconstruction against the JAX package.

On the CPU the port's flat t-pass runs the kernel's plain torch twin;
the reference is pbrt_tpu's t_pass_brute. Same random triangles and
rays (NumPy, seeded) on both sides, with dead rays, short tmax and
zero directions mixed in.

Tolerances: prim ids must be identical (same strict '<' fold, lowest
index on ties). t within 1e-5 relative: XLA's CPU backend contracts
multiply-add pairs into FMAs that ATen rounds separately, which moves
t by a few ulp.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.accel.intersect import SceneGeom as JGeom
from pbrt_tpu.accel.intersect import make_tri_pack as j_make_tri_pack
from pbrt_tpu.accel.intersect import reconstruct as j_reconstruct
from pbrt_tpu.accel.intersect import t_pass_brute as j_t_pass_brute
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.accel.intersect import reconstruct, t_pass_brute
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.ops.intersect_cuda import TriSoA, tri_t_pass


def random_geom_arrays(n, seed):
    """NumPy triangle soup with shading normals and uvs (geom.* keys)."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    v0 = c - (e1 + e2) / 3.0
    nrm = rng.normal(size=(n, 3, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    has_n = rng.rand(n) < 0.5
    uv = rng.rand(n, 3, 2).astype(np.float32)
    uv[: n // 10] = 0.0                      # degenerate uv -> fallback dpdu
    mat = rng.randint(-1, 3, n).astype(np.int32)
    light = rng.randint(-1, 2, n).astype(np.int32)
    return {
        "geom.tri_v0": v0, "geom.tri_e1": e1, "geom.tri_e2": e2, "geom.tri_n": nrm,
        "geom.tri_has_n": has_n, "geom.tri_uv": uv, "geom.tri_mat": mat,
        "geom.tri_light": light, "geom.world_lo": np.full(3, -6, np.float32),
        "geom.world_hi": np.full(3, 6, np.float32),
        "geom.tri_pack": j_make_tri_pack(v0, e1, e2, nrm, uv, has_n, mat, light),
    }


def random_rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 16] = 0.0                       # degenerate directions
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, np.inf, np.float32)
    tmax[n // 16: n // 8] = -1.0             # dead rays
    tmax[n // 8: n // 4] = 3.0               # short tmax
    return o, d, tmin, tmax


def jax_geom(a):
    g = {k.split(".", 1)[1]: jnp.asarray(v) for k, v in a.items()}
    return JGeom(quad_type=jnp.zeros((0,), jnp.int32), quad_o2w=jnp.zeros((0, 4, 4)),
                 quad_w2o=jnp.zeros((0, 4, 4)), quad_params=jnp.zeros((0, 8)),
                 quad_mat=jnp.zeros((0,), jnp.int32), quad_light=jnp.zeros((0,), jnp.int32),
                 quad_flip=jnp.zeros((0,), bool),
                 quad_pack=jnp.zeros((0, 34), jnp.float32), **g)


@pytest.fixture(scope="module")
def scene():
    a = random_geom_arrays(600, seed=1)
    rays = random_rays(3000, seed=2)
    jg = jax_geom(a)
    jr = JRay(*(jnp.asarray(x) for x in rays), jnp.zeros(len(rays[0])))
    t_ref, p_ref = j_t_pass_brute(jg, jr)
    return a, rays, jg, jr, np.array(t_ref), np.array(p_ref)


def _check(t, p, t_ref, p_ref):
    np.testing.assert_array_equal(p, p_ref)
    hit = p_ref >= 0
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
    assert np.all(t[~hit] == 1e30)


def test_flat_t_pass_matches_brute(scene):
    a, (o, d, tmin, tmax), _, _, t_ref, p_ref = scene
    geom = bridge.from_arrays(a, "geom", "cpu")
    soa = TriSoA(geom.tri_v0, geom.tri_e1, geom.tri_e2)
    t, p = tri_t_pass(soa, *(torch.as_tensor(x) for x in (o, d, tmin, tmax)))
    assert p.dtype == torch.int64
    _check(t.numpy(), p.numpy(), t_ref, p_ref)


def test_t_pass_brute_matches_brute(scene):
    a, rays, _, _, t_ref, p_ref = scene
    geom = bridge.from_arrays(a, "geom", "cpu")
    ray = Ray(*(torch.as_tensor(x) for x in rays), torch.zeros(len(rays[0])))
    t, p = t_pass_brute(geom, ray)
    _check(t.numpy(), p.numpy(), t_ref, p_ref)


def test_reconstruct_matches(scene):
    """Differential geometry of the winning triangle from the same
    (t, prim): rsqrt/division rounding differs by ulps (atol 1e-5)."""
    a, rays, jg, jr, t_ref, p_ref = scene
    ref = j_reconstruct(jg, jr, jnp.asarray(t_ref), jnp.asarray(p_ref))
    geom = bridge.from_arrays(a, "geom", "cpu")
    ray = Ray(*(torch.as_tensor(x) for x in rays), torch.zeros(len(rays[0])))
    hit = reconstruct(geom, ray, torch.as_tensor(t_ref), torch.as_tensor(p_ref).long())
    for name, r, g in zip(ref._fields, ref, hit):
        r, g = np.asarray(r), g.numpy()
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5, err_msg=name)
