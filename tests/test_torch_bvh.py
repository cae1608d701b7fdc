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

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


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


def test_plain_sweeps_with_dead_lanes_match(wide, monkeypatch):
    """Every tile has dead lanes (tmin >= tmax), one tile has no live lane
    at all, so the plain sweeps test fewer lanes than a tile holds. Prim
    ids identical to pbrt_tpu's _sweep_pairs(interpret=True), t within
    1e-5 relative (the module's FMA tolerance) or 1e-6 absolute (a near
    hit's t is rounded on the scale of the coordinates, ~10); and both
    plain sweeps bit for bit equal to the fold that tests every lane of
    every tile."""
    _, _, jw, tw = wide
    rng = np.random.RandomState(11)
    T = 4
    o, d, tmin, tmax = random_rays(T * TILE, seed=12)
    tmax = np.where(np.isfinite(tmax), tmax, 1e30).astype(np.float32)
    live_frac = np.repeat([0.5, 0.9, 0.0, 0.03], TILE)
    dead = rng.rand(T * TILE) >= live_frac
    tmin = np.where(dead & (rng.rand(T * TILE) < 0.5), tmax, tmin)     # tmin == tmax
    tmin = np.where(dead & (tmin < tmax), tmax + 1.0, tmin).astype(np.float32)
    rays8 = np.concatenate([o, d, tmin[:, None], tmax[:, None]], -1)
    t0 = rng.uniform(1, 12, T * TILE).astype(np.float32)
    B = tw.n_blocks
    lst = np.full((T, MAX_L), B, np.int32)
    nl = np.array([B, B - 1, B, B - 3], np.int32)
    for i in range(T):
        lst[i, :nl[i]] = rng.permutation(B)[:nl[i]]

    pair_tile, pair_block, total = jbp._compact_pairs(jnp.asarray(lst), jnp.asarray(nl), T, B)
    assert int(total) <= jbp.PAIR_CHUNK
    rays8p = np.concatenate([rays8, np.zeros((TILE, 8), np.float32)])
    t3 = np.concatenate([t0, np.full(TILE, -1e30, np.float32)]).reshape(T + 1, 8, 128)
    p3 = np.full((T + 1, 8, 128), -1, np.int32)
    t_ref, p_ref = jbp._sweep_pairs(pair_tile[:jbp.PAIR_CHUNK], pair_block[:jbp.PAIR_CHUNK],
                                    jnp.asarray(rays8p), jnp.asarray(t3), jnp.asarray(p3),
                                    jw.tris16, interpret=True)
    t_ref = np.asarray(t_ref)[:T].reshape(-1)
    p_ref = np.asarray(p_ref)[:T].reshape(-1)

    rays = torch.as_tensor(rays8).contiguous()
    live = (rays[:, 6] < rays[:, 7]).view(T, TILE)
    assert int(live[2].sum()) == 0 and bool((live.sum(1) < TILE).all())
    assert bvh_cuda._live_lanes(rays).shape == (T, int(live.sum(1).max()))
    pb, start, count = bvh_cuda._compact_pairs(torch.as_tensor(lst), torch.as_tensor(nl))
    args = (pb, start, count, rays, tw.tris16, tw.n_blocks)
    p_init = torch.full((T * TILE,), -1, dtype=torch.int32)
    chunks = list(range(-(-int(count.max()) // 3) - 1, -1, -1))   # merged last chunk first

    def sweeps():
        t_p, p_p = bvh_cuda.wide_sweep_plain(*args, torch.as_tensor(t0).clone(), p_init.clone())
        t_c, p_c = bvh_cuda.wide_sweep_chunked(*args, torch.as_tensor(t0).clone(),
                                               p_init.clone(), chunk=3, order=chunks)
        return (t_p, p_p), (t_c, p_c)

    got = sweeps()
    monkeypatch.setattr(bvh_cuda, "_live_lanes", lambda r: torch.arange(TILE).expand(T, TILE))
    full = sweeps()[0]
    for t, p in got:
        np.testing.assert_array_equal(p.numpy(), p_ref)
        np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-5, atol=1e-6)
        assert torch.equal(p, full[1]) and torch.equal(t.view(torch.int32),
                                                       full[0].view(torch.int32))
    hit = p_ref >= 0
    assert hit.sum() > 100 and not hit[dead].any() and not hit[2 * TILE:3 * TILE].any()


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


def test_wide_bvh_with_quadrics_matches_jax(tmp_path):
    """A scene of 10,370 triangles and two quadrics that reach outside the
    triangles' box: the narrow tree is built over the triangles' and the
    quadrics' bounds, as in the JAX package, and the wide collapse drops
    the quadrics from the leaves. Every array of the port's wide BVH
    equals the JAX package's build_bvh + build_wide_bvh on its compiled
    geometry (the root box, the leaf blocks and their count included)."""
    from pbrt_tpu.scene import api as j_api
    from pbrt_tpu.scene import parser as j_parser
    from pbrt_tpu.scene.compile import compile_scene as j_compile
    from pbrt_tpu_torch.scene import api as t_api
    from pbrt_tpu_torch.scene import parser as t_parser
    from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
    from test_torch_slice import _parse, mesh, uv_sphere

    P, idx = uv_sphere(72, 1.0, (0.0, 0.4, 0.0))
    path = tmp_path / "wide.pbrt"
    path.write_text('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
                    "WorldBegin\n" + mesh(P, idx)
                    + mesh(np.array([[-3, -0.6, -3], [3, -0.6, -3], [3, -0.6, 3], [-3, -0.6, 3]]),
                           np.array([0, 2, 1, 0, 3, 2]))
                    + 'AttributeBegin\nTranslate 0.5 3 0\nShape "sphere" "float radius" [0.6]\n'
                    'AttributeEnd\nAttributeBegin\nTranslate -4 0 1\nRotate 90 1 0 0\n'
                    'Shape "cylinder" "float radius" [0.3]\nAttributeEnd\nWorldEnd\n')
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    assert ts.geom.n_tris == js.geom.n_tris == 10370 and ts.geom.n_quads == 2
    jw = j_build_wide_bvh(j_build_bvh(js.geom, "sah"), js.geom)
    tw = ts.accel.wide
    assert tw.n_blocks == jw.n_blocks
    for f in bridge.WIDE_FIELDS:
        np.testing.assert_array_equal(getattr(tw, f).numpy(), np.asarray(getattr(jw, f)),
                                      err_msg=f)
    # the quadrics widen the root box beyond the triangles'
    assert float(tw.world_hi[1]) > 3.5 and float(tw.world_lo[0]) < -4.2
    assert float(ts.geom.tri_v0[:, 1].max()) < 1.5


# ---------------------------------------------------------------------------
# K2's decomposition: chunks of a tile's run merged in any order by key

@pytest.fixture(scope="module")
def adversarial():
    """The card test's adversarial pair list, cut to 8 tiles, and the
    sequential fold of wide_sweep_plain over it."""
    from test_torch_gpu import adversarial_sweep_case

    args, keep = adversarial_sweep_case("cpu", n_tiles=8)
    *inputs, t0, p0 = args
    t_ref, p_ref = bvh_cuda.wide_sweep_plain(*inputs, t0.clone(), p0.clone())
    return inputs, t0, p0, t_ref, p_ref, keep


@pytest.mark.parametrize("order", ["reverse", "forward", "shuffle"])
@pytest.mark.parametrize("chunk", [1, bvh_cuda.SWEEP_CHUNK, 3, MAX_L])
def test_chunked_merge_matches_sequential_fold(adversarial, chunk, order):
    """wide_sweep_chunked (the kernel's items and key merge, in torch)
    equals the sequential fold bit for bit: ties across pairs listed in
    both orders, a tie with the starting accumulator, sentinel pairs, an
    empty tile, dead rays and a full MAX_L run."""
    inputs, t0, p0, t_ref, p_ref, keep = adversarial
    count = inputs[2]
    n_chunks = -(-int(count.max()) // chunk)
    chunks = {"reverse": range(n_chunks - 1, -1, -1), "forward": range(n_chunks),
              "shuffle": np.random.RandomState(chunk).permutation(n_chunks)}[order]
    t, p = bvh_cuda.wide_sweep_chunked(*inputs, t0.clone(), p0.clone(), chunk=chunk,
                                       order=[int(c) for c in chunks])
    assert torch.equal(p, p_ref)
    assert torch.equal(t.view(torch.int32), t_ref.view(torch.int32))
    # the case really holds what it claims
    tiles_p = p_ref.view(-1, TILE)
    tiles_t0 = t0.view(-1, TILE)
    assert int(count[0]) == MAX_L and int(count[5]) == 0
    assert torch.equal(tiles_p[5], p0.view(-1, TILE)[5])
    assert bool((p_ref[keep] == 424242).all()) and int(keep.sum()) > 50
    dead = t0 == -bvh_cuda.BIG
    assert bool(dead.any()) and torch.equal(p_ref[dead], p0[dead])
    hit12 = (tiles_p[1] >= 0) & (tiles_p[2] >= 0) & (tiles_t0[1] > 1e29) & (tiles_t0[2] > 1e29)
    a, b = inputs[0][inputs[1][1]], inputs[0][inputs[1][2]]   # first block of tiles 1 and 2
    assert int(hit12.sum()) > 100
    assert bool((tiles_p[1][hit12] // 128 == a).all()) and bool((tiles_p[2][hit12] // 128 == b).all())


def test_merge_keys_order_and_roundtrip():
    """pack_keys orders candidates by (t, pos, slot) with -0.0 == +0.0,
    and unpack_keys gives back every bit of t."""
    rng = np.random.RandomState(3)
    special = np.array([0.0, -0.0, 1e30, -1e30, 1e-40, -1e-40, 1.0, -1.0, 3.4e38, -3.4e38],
                       np.float32)
    t = np.concatenate([special, rng.normal(0, 10, 500).astype(np.float32),
                        rng.choice(special, 200)])
    pos = rng.randint(0, bvh_cuda.MAX_RUN, t.size)
    slot = rng.randint(0, 128, t.size)
    keys = bvh_cuda.pack_keys(torch.as_tensor(t), torch.as_tensor(pos), torch.as_tensor(slot))
    t2, pos2, slot2 = bvh_cuda.unpack_keys(keys)
    np.testing.assert_array_equal(t2.numpy().view(np.int32), t.view(np.int32))
    np.testing.assert_array_equal(pos2.numpy(), pos)
    np.testing.assert_array_equal(slot2.numpy(), slot)
    # every candidate (a hit below 1e30, or 1e30) keys below the empty key
    assert bool((keys[torch.as_tensor(t <= 1e30)] < bvh_cuda.KEY_EMPTY).all())
    lex = np.lexsort((slot, pos, t + np.float32(0.0)))   # -0.0 + 0.0 == +0.0
    k = keys.numpy()[lex]
    assert (np.diff(k) >= 0).all()
    same = (np.diff(t[lex] + np.float32(0.0)) == 0) & (np.diff(pos[lex]) == 0) & \
        (np.diff(slot[lex]) == 0)
    assert ((np.diff(k) == 0) <= same).all()


def test_port_builds_with_its_own_builder_source():
    """In a fresh interpreter the port builds a BVH and imports its
    textures, noise and measured-BRDF modules (and the bridge), and its
    lights, samplers (reading its own best-candidate table), cameras,
    transforms, probes, compiler and render driver (and the realistic
    camera, the extra integrators with the SH module, the surfacepoints
    and createprobes renderers, and the loopsubdiv and nurbs shapes; the
    threefry streams, the bidirectional paths, the metropolis and
    aggregatetest renderers, the grid and kd-tree accelerators, every
    tool module, the gradients' diff module and the process-group mesh),
    without importing jax or pbrt_tpu and without opening or running anything under
    pbrt_tpu/; its builder source is byte-identical to the
    reference's."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = f"""
import os, sys
ref = os.path.join({repo!r}, "pbrt_tpu") + os.sep
touched = []
def hook(event, args):
    if event in ("open", "subprocess.Popen", "os.posix_spawn", "os.exec", "os.system"):
        if ref in repr(args):
            touched.append((event, repr(args)[:200]))
sys.addaudithook(hook)
import numpy as np
import pbrt_tpu_torch.main
from pbrt_tpu_torch.accel import bvh
rng = np.random.RandomState(0)
v0, e1, e2 = (rng.normal(size=(40, 3)).astype(np.float32) for _ in range(3))
tree = bvh.build_bvh(v0, e1, e2, "sah")
assert tree is not None and len(tree.prim_ids) == 40
import pbrt_tpu_torch.bridge, pbrt_tpu_torch.materials.measured
from pbrt_tpu_torch.textures import noise, registry
from pbrt_tpu_torch.core import probes, sampling, transform
from pbrt_tpu_torch.samplers import samplers
from pbrt_tpu_torch.cameras import cameras
from pbrt_tpu_torch.lights import lighting
from pbrt_tpu_torch.scene import api, compile, records
from pbrt_tpu_torch.renderers import driver, surfacepoints, createprobes
from pbrt_tpu_torch.cameras import realistic
from pbrt_tpu_torch.integrators import extra
from pbrt_tpu_torch.core import sh
from pbrt_tpu_torch.shapes import loopsubdiv, nurbs
from pbrt_tpu_torch.core import threefry
from pbrt_tpu_torch.integrators import bidir
from pbrt_tpu_torch.renderers import metropolis, aggregatetest
from pbrt_tpu_torch.accel import grid, kdtree
from pbrt_tpu_torch.tools import __main__ as tools_main, bsdftest, converters, exrtools
from pbrt_tpu_torch import diff
from pbrt_tpu_torch.parallel import mesh
assert samplers._bc_buckets(4)[1].shape[1:] == (4, 2)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "pbrt_tpu")]
assert not bad, bad
assert not touched, touched
assert bvh.NATIVE_SRC.startswith(os.path.join({repo!r}, "pbrt_tpu_torch") + os.sep)
copy = open(bvh.NATIVE_SRC, "rb").read()
assert copy == open(ref + "native/bvh_builder.cpp", "rb").read()
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=repo)
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
