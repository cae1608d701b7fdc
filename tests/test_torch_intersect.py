"""K1 module (flat t-pass) and hit reconstruction against the JAX package.

On the CPU the port's flat t-pass runs the kernel's plain torch twin;
the reference is pbrt_tpu's t_pass_brute. Same random triangles and
rays (NumPy, seeded) on both sides, with dead rays, short tmax and
zero directions mixed in.

K1's decomposition (live rays only, chunks of stages merged by key in
any order: tri_t_pass_chunked) is held bit for bit against the plain
twin, and the plain twin against pbrt_tpu's Pallas kernel body
`_tri_kernel` run in interpret mode, on the adversarial case of
tests/test_torch_gpu.py.

Tolerances: prim ids must be identical (same strict '<' fold, lowest
index on ties). t within 1e-5 relative against t_pass_brute: XLA's CPU
backend contracts multiply-add pairs into FMAs that ATen rounds
separately, which moves t by a few ulp. Against the Pallas kernel body
t within 1e-4 relative: the same contraction, but over the kernel's
[rays, 256] outer products XLA fuses differently and moved t by up to
2.9e-5 relative on one seed of this case (8e-7 on the seed used here).
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
from pbrt_tpu_torch.ops import intersect_cuda as k1
from pbrt_tpu_torch.ops.intersect_cuda import TriSoA, tri_t_pass
from test_torch_gpu import adversarial_k1_case

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


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


# ---------------------------------------------------------------------------
# K1's plain twin against the Pallas kernel body, and K1's decomposition

def pallas_tri_t_pass(rays8, tris9, n_tris):
    """pbrt_tpu's `_tri_kernel` in interpret mode, with the specs of
    `_tri_t_pass` (intersect_pallas.py:98-118) and the miss rule of
    `tri_t_pass_pallas` (:152-153). NumPy in and out."""
    import jax
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from pbrt_tpu.ops.intersect_pallas import BIG, TB, TR, _tri_kernel

    R, T = rays8.shape[0], tris9.shape[1]
    acc = pl.BlockSpec((1, 8, TR // 8), lambda i, j: (i, 0, 0), memory_space=pltpu.VMEM)
    t, p = pl.pallas_call(
        _tri_kernel,
        grid=(R // TR, T // TB),
        in_specs=[pl.BlockSpec((TR, 8), lambda i, j: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((9, TB), lambda i, j: (0, j), memory_space=pltpu.VMEM)],
        out_specs=[acc, acc],
        out_shape=[jax.ShapeDtypeStruct((R // TR, 8, TR // 8), jnp.float32),
                   jax.ShapeDtypeStruct((R // TR, 8, TR // 8), jnp.int32)],
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel", "arbitrary")),
        interpret=True,
    )(jnp.asarray(rays8), jnp.asarray(tris9))
    t, p = np.asarray(t).reshape(-1), np.asarray(p).reshape(-1)
    miss = (p < 0) | (p >= n_tris) | (t >= BIG)
    return np.where(miss, BIG, t).astype(np.float32), np.where(miss, -1, p)


@pytest.fixture(scope="module")
def k1_cases():
    """The adversarial K1 case (3072 rays x 600 triangles in 3 stages)
    with half and with all of its rays dead, and the plain twin's result."""
    out = {}
    for dead in ("half", "all"):
        rays8, tris9, n, info = adversarial_k1_case(3072, 600, seed=21, dead=dead)
        rays8, tris9 = torch.as_tensor(rays8), torch.as_tensor(tris9)
        out[dead] = (rays8, tris9, n, info, *k1.tri_t_pass_plain(rays8, tris9, n))
    return out


def test_plain_twin_matches_pallas_kernel(k1_cases):
    rays8, tris9, n, info, t, p = k1_cases["half"]
    t_ref, p_ref = pallas_tri_t_pass(rays8.numpy(), tris9.numpy(), n)
    t, p = t.numpy(), p.numpy()
    np.testing.assert_array_equal(p, p_ref)
    hit = p_ref >= 0
    assert hit.sum() > 300
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-4, atol=0)
    assert np.all(t[~hit] == 1e30) and np.all(t_ref[~hit] == 1e30)
    # the ties across stage boundaries went to the lower index on both sides
    assert np.isin(p_ref, info["dup_src"]).sum() > 50 and not np.isin(p_ref, info["dup_dst"]).any()


@pytest.mark.parametrize("dead", ["half", "all"])
@pytest.mark.parametrize("order", ["forward", "reverse", "shuffle"])
@pytest.mark.parametrize("chunk", [1, 2, "all"])
def test_chunked_merge_matches_plain(k1_cases, dead, chunk, order):
    """tri_t_pass_chunked (the kernel's live-ray list, chunks and key
    merge, in torch) equals the plain twin bit for bit: ties at equal t
    in different stages, t = -0.0 and +0.0 from tmin < 0, dead rays of
    every kind, zero directions, a short tmax, n_tris not a multiple of
    256."""
    rays8, tris9, n, info, t_ref, p_ref = k1_cases[dead]
    n_stages = tris9.shape[1] // k1.TB
    chunk = n_stages if chunk == "all" else chunk
    n_chunks = -(-n_stages // chunk)
    chunks = {"forward": range(n_chunks), "reverse": range(n_chunks - 1, -1, -1),
              "shuffle": np.random.RandomState(chunk).permutation(n_chunks)}[order]
    t, p = k1.tri_t_pass_chunked(rays8, tris9, n, chunk, [int(c) for c in chunks])
    assert p.dtype == torch.int32
    assert torch.equal(p, p_ref)
    assert torch.equal(t.view(torch.int32), t_ref.view(torch.int32))
    # the case really holds what it claims
    dead_rays = torch.as_tensor(info["dead"])
    assert bool((p_ref[dead_rays] == -1).all()) and bool((t_ref[dead_rays] == 1e30).all())
    if dead == "half":
        assert n % k1.TB and 0.4 < float(dead_rays.float().mean()) < 0.6
        bits = t_ref.view(torch.int32)
        neg, pos = torch.as_tensor(info["neg_zero"]), torch.as_tensor(info["pos_zero"])
        assert int(neg.sum()) > 10 and bool((bits[neg] == -(1 << 31)).all())
        assert int(pos.sum()) > 10 and bool((bits[pos] == 0).all())
        assert bool((p_ref[pos] >= 0).all())
        assert np.isin(p_ref.numpy(), info["dup_src"]).sum() > 50
        assert not np.isin(p_ref.numpy(), info["dup_dst"]).any()
    else:
        assert bool(dead_rays.all())


def test_k1_keys_order_and_roundtrip():
    """pack_keys orders candidates by (t, prim) with -0.0 == +0.0,
    unpack_keys gives back every bit of t, and every candidate keys below
    the empty key."""
    rng = np.random.RandomState(3)
    special = np.array([0.0, -0.0, 1e30, -1e30, 1e-40, -1e-40, 1.0, -1.0, 3.4e38, -3.4e38],
                       np.float32)
    t = np.concatenate([special, rng.normal(0, 10, 500).astype(np.float32),
                        rng.choice(special, 200)])
    prim = rng.randint(0, 1 << 30, t.size)
    prim[:40] = rng.randint(0, 4, 40)        # equal prims with other t
    keys = k1.pack_keys(torch.as_tensor(t), torch.as_tensor(prim))
    t2, prim2 = k1.unpack_keys(keys)
    np.testing.assert_array_equal(t2.numpy().view(np.int32), t.view(np.int32))
    np.testing.assert_array_equal(prim2.numpy(), prim)
    assert bool((keys[torch.as_tensor(t <= 1e30)] < k1.KEY_EMPTY).all())
    lex = np.lexsort((prim, t + np.float32(0.0)))   # -0.0 + 0.0 == +0.0
    k = keys.numpy()[lex]
    assert (np.diff(k) >= 0).all()
    same = (np.diff(t[lex] + np.float32(0.0)) == 0) & (np.diff(prim[lex]) == 0)
    assert ((np.diff(k) == 0) <= same).all()
    # finish_keys: the miss rule on the empty key, t >= 1e30 and a padded
    # prim; a hit passes
    fk = torch.cat([torch.tensor([k1.KEY_EMPTY]),
                    k1.pack_keys(torch.tensor([1e30, 2.5, 2.5]), torch.tensor([3, 700, 5]))])
    tf, pf = k1.finish_keys(fk, n_tris=600)
    assert pf.tolist() == [-1, -1, -1, 5]
    assert bool((tf[:3] == 1e30).all()) and float(tf[3]) == 2.5


def test_cuda_wrapper_refuses_cpu_tensors(k1_cases):
    """No fallback: the kernel's wrapper raises on CPU tensors (the
    dispatcher, not the wrapper, picks the plain twin for them)."""
    rays8, tris9, n = k1_cases["half"][:3]
    with pytest.raises(ValueError, match="CUDA"):
        k1.tri_t_pass_cuda(rays8, tris9, n)
