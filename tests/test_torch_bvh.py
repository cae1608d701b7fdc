"""K2 module (wide-leaf packet t-pass) against the JAX package.

The wide BVH is built by the JAX package and handed to the port through
`bridge`, so both sides sweep identical leaf blocks. On the CPU the
port runs the kernel's plain torch twin; the JAX side runs its Pallas
sweep in interpret mode (as tests/test_accel.py does).

Tolerances: prim ids must be identical (same pair order per tile, same
strict '<' fold). t within 1e-5 relative: XLA's CPU backend contracts
multiply-add pairs into FMAs that ATen rounds separately. Any-hit
queries return SOME hit, so only the hit mask is compared there.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.accel.bvh import build_bvh as j_build_bvh
from pbrt_tpu.accel.intersect import t_pass_brute as j_t_pass_brute
from pbrt_tpu.accel.wide_bvh import build_wide_bvh as j_build_wide_bvh
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.ops import bvh_pallas as jbp
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.accel.wide_bvh import MAX_L, TILE, build_wide_bvh
from pbrt_tpu_torch.ops import bvh_cuda
from test_torch_intersect import jax_geom, random_geom_arrays, random_rays


@pytest.fixture(scope="module")
def wide():
    a = random_geom_arrays(900, seed=5)
    jg = jax_geom(a)
    jw = j_build_wide_bvh(j_build_bvh(jg, "sah"), jg)
    arrays = {f"wide.{f}": np.asarray(getattr(jw, f)) for f in bridge.WIDE_FIELDS}
    arrays["wide.n_blocks"] = np.asarray(jw.n_blocks)
    return a, jg, jw, bridge.from_arrays(arrays, "wide", "cpu")


def test_port_builds_the_same_wide_bvh(wide):
    """Same native builder, same collapse: identical wide layout."""
    a, _, jw, _ = wide
    v0, e1, e2 = a["geom.tri_v0"], a["geom.tri_e1"], a["geom.tri_e2"]
    tw = build_wide_bvh(build_bvh(v0, e1, e2, "sah"), v0, e1, e2, "cpu")
    assert tw.n_blocks == jw.n_blocks > 4
    for f in bridge.WIDE_FIELDS:
        np.testing.assert_array_equal(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)),
                                      err_msg=f)


def test_plain_sweep_matches_pallas_sweep(wide):
    """Identical pair lists through both sweeps: the port's plain twin of
    K2 vs pbrt_tpu's _sweep_pairs(interpret=True)."""
    _, _, jw, tw = wide
    rng = np.random.RandomState(7)
    T = 3
    o, d, tmin, tmax = random_rays(T * TILE, seed=8)
    rays8 = np.concatenate([o, d, tmin[:, None],
                            np.where(np.isfinite(tmax), tmax, 1e30)[:, None]], -1)
    t0 = np.where(rng.rand(T * TILE) < 0.1, -1e30, rng.uniform(1, 12, T * TILE))
    t0 = t0.astype(np.float32)
    # per tile: some blocks in random order (tile 2 gets none), then
    # sentinel padding
    B = tw.n_blocks
    lst = np.full((T, MAX_L), B, np.int32)
    nl = np.array([B, B - 2, 0], np.int32)
    for i in range(T):
        lst[i, :nl[i]] = rng.permutation(B)[:nl[i]]

    pair_tile, pair_block, total = jbp._compact_pairs(jnp.asarray(lst), jnp.asarray(nl),
                                                      T, B)
    assert int(total) <= jbp.PAIR_CHUNK
    rays8p = np.concatenate([rays8, np.zeros((TILE, 8), np.float32)])
    t3 = np.concatenate([t0, np.full(TILE, -1e30, np.float32)]).reshape(T + 1, 8, 128)
    p3 = np.full((T + 1, 8, 128), -1, np.int32)
    t_ref, p_ref = jbp._sweep_pairs(pair_tile[:jbp.PAIR_CHUNK], pair_block[:jbp.PAIR_CHUNK],
                                    jnp.asarray(rays8p), jnp.asarray(t3), jnp.asarray(p3),
                                    jw.tris16, interpret=True)
    t_ref = np.asarray(t_ref)[:T].reshape(-1)
    p_ref = np.asarray(p_ref)[:T].reshape(-1)

    pb, start, count = bvh_cuda._compact_pairs(torch.as_tensor(lst), torch.as_tensor(nl))
    t_acc, p_acc = torch.as_tensor(t0).clone(), torch.full((T * TILE,), -1, dtype=torch.int32)
    bvh_cuda.wide_sweep(pb, start, count, torch.as_tensor(rays8).contiguous(), tw.tris16,
                        tw.n_blocks, t_acc, p_acc)
    np.testing.assert_array_equal(p_acc.numpy(), p_ref)
    assert (p_ref >= 0).sum() > 100
    np.testing.assert_allclose(t_acc.numpy(), t_ref, rtol=1e-5)


@pytest.mark.parametrize("coherent", [False, True])
@pytest.mark.parametrize("any_hit", [False, True])
def test_wide_t_pass_matches_pallas(wide, coherent, any_hit, monkeypatch):
    """wide_t_pass end to end (sort, cull, compaction, waves, sweep,
    unsort) vs pbrt_tpu's wide_t_pass(interpret=True). The per-ray cull
    runs one tile per chunk here, so chunk boundaries are covered."""
    monkeypatch.setattr(bvh_cuda, "CULL_BYTES", 1)
    a, jg, jw, tw = wide
    o, d, tmin, tmax = random_rays(2500, seed=9)
    if coherent:                              # camera-like beam
        o[:] = [0.0, 0.0, -7.0]
        d = np.random.RandomState(3).normal([0, 0, 1], 0.3, (len(o), 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_ref, p_ref = jbp.wide_t_pass(jw, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                                   jnp.asarray(tmax), any_hit=any_hit, coherent=coherent,
                                   interpret=True)
    t_ref, p_ref = np.asarray(t_ref), np.asarray(p_ref)
    t, p = bvh_cuda.wide_t_pass(tw, *(torch.as_tensor(x) for x in (o, d, tmin, tmax)),
                                any_hit=any_hit, coherent=coherent)
    t, p = t.numpy(), p.numpy()
    hit = p_ref >= 0
    assert 0.05 < hit.mean() < 0.95
    if any_hit:
        np.testing.assert_array_equal(p >= 0, hit)
        return
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
    # and both agree with brute force
    _, p_b = j_t_pass_brute(jg, JRay(*(jnp.asarray(x) for x in (o, d, tmin, tmax)),
                                     jnp.zeros(len(o))))
    np.testing.assert_array_equal(p, np.asarray(p_b))
