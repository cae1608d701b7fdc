"""The port's samplers, sampling tables, cameras and transforms against
the JAX package's on the same seeded inputs.

Distribution2D (the environment-map importance table), the Halton
radical inverse, the best-candidate buckets, the camera samples of the
halton, bestcandidate and adaptive samplers, the adaptive vetoes, the
orthographic and environment cameras and AnimatedTransform.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import cameras as j_cam
from pbrt_tpu.core import sampling as j_smp
from pbrt_tpu.core import transform as j_tf
from pbrt_tpu.samplers import samplers as j_sam
from pbrt_tpu.scene.paramset import ParamSet as JParamSet
from pbrt_tpu_torch.cameras import cameras as t_cam
from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import sampling as t_smp
from pbrt_tpu_torch.core import transform as t_tf
from pbrt_tpu_torch.samplers import samplers as t_sam
from pbrt_tpu_torch.scene.paramset import ParamSet as TParamSet

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def flat_run_table(seed=0, nv=24, nu=40):
    """A luminance x sin(theta) table with zero texels: whole zero rows
    (the uniform fallback), zero column runs (flat CDF runs) and a few
    bright texels."""
    rng = np.random.RandomState(seed)
    f = rng.rand(nv, nu).astype(np.float32)
    f[:, 5:12] = 0.0
    f[3] = 0.0
    f[7, :] = 0.0
    f[7, 20] = 9.0
    f[10, 30:] = 0.0
    f *= np.sin(np.pi * (np.arange(nv) + 0.5) / nv)[:, None].astype(np.float32)
    return f


def _to_torch_dist2d(jd):
    def d1(x):
        return t_smp.Distribution1D(*(torch.as_tensor(np.array(a)) for a in x))

    return t_smp.Distribution2D(d1(jd.cond), d1(jd.marg))


def test_distribution2d_tables_match_jax():
    """The host-built tables (NumPy float32, running sums left to right)
    against the JAX package's XLA cumsum: within 1e-6 relative."""
    f = flat_run_table()
    jd = j_smp.Distribution2D.make(f)
    td = t_smp.Distribution2D.make(f, "cpu")
    for part in ("cond", "marg"):
        for field in ("func", "cdf", "func_int"):
            np.testing.assert_allclose(getattr(getattr(td, part), field).numpy(),
                                       np.asarray(getattr(getattr(jd, part), field)),
                                       rtol=1e-6, atol=0, err_msg=f"{part}.{field}")


def test_distribution2d_sample_and_pdf_match_jax():
    """Same tables in both packages (the JAX package's, bridged): the
    sorted search picks exactly the segment of the JAX count rule, also
    for u on the CDF values themselves and in flat runs; (u, v) agree
    within 1e-6 and the pdfs within 1e-6 relative."""
    f = flat_run_table()
    jd = j_smp.Distribution2D.make(f)
    td = _to_torch_dist2d(jd)
    rng = np.random.RandomState(1)
    n = 4000
    u0 = rng.rand(n).astype(np.float32)
    u1 = rng.rand(n).astype(np.float32)
    # u on CDF values: exact ties of the >= rule, inside flat runs too
    cc = np.asarray(jd.cond.cdf)
    mc = np.asarray(jd.marg.cdf)
    u1[:500] = mc[rng.randint(0, len(mc) - 1, 500)]
    iv_ref = np.clip(np.searchsorted(mc, u1, side="right") - 1, 0, len(mc) - 2)
    u0[:1000] = cc[iv_ref[:1000], rng.randint(0, cc.shape[1] - 1, 1000)]

    _, _, iv = td.marg.sample_continuous(torch.as_tensor(u1))
    np.testing.assert_array_equal(iv.numpy(), iv_ref)
    off = td.column(iv, torch.as_tensor(u0)).numpy()
    off_ref = np.clip((u0[:, None] >= cc[iv_ref, 1:]).sum(-1), 0, cc.shape[1] - 2)
    np.testing.assert_array_equal(off, off_ref)
    row = cc[iv_ref]
    on_cdf = u0[:, None] == row
    flat = on_cdf[:, 1:-1] & (row[:, 1:-1] == row[:, 2:])   # u on a flat run's value
    assert on_cdf.any(-1).sum() > 200 and flat.any(-1).sum() > 50

    (ju, jv), jpdf = jd.sample_continuous(jnp.asarray(u0), jnp.asarray(u1))
    (tu, tv), tpdf = td.sample_continuous(torch.as_tensor(u0), torch.as_tensor(u1))
    # (u, v) in [0, 1): within 1e-6 (XLA contracts (off + du) / n with
    # FMAs: up to ~10 ulp); the pdf within 1e-6 relative
    for got, ref in ((tu, ju), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tpdf.numpy(), np.asarray(jpdf), rtol=1e-6)
    # the pdf at sampled and at arbitrary points
    uu, vv = rng.rand(2, n).astype(np.float32)
    np.testing.assert_allclose(td.pdf(torch.as_tensor(uu), torch.as_tensor(vv)).numpy(),
                               np.asarray(jd.pdf(jnp.asarray(uu), jnp.asarray(vv))), rtol=1e-6)
    # 1D sample_continuous (the marginal), the JAX package's searchsorted form
    jx, jp, joff = j_smp.Distribution1D.make(f[4]).sample_continuous(jnp.asarray(u1))
    tx, tp, toff = t_smp.Distribution1D.make(torch.as_tensor(f[4])).sample_continuous(
        torch.as_tensor(u1))
    np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)


def test_radical_inverse_and_halton_are_bit_equal():
    """32 digits in float32 in the JAX package's compiled order: equal
    bit for bit in every one of the 32 prime bases."""
    rng = np.random.RandomState(2)
    n = np.concatenate([np.arange(3000), rng.randint(0, 2 ** 31 - 1, 3000)]).astype(np.int32)
    for base in j_smp._PRIMES.tolist():
        ref = np.asarray(j_smp.radical_inverse(jnp.asarray(n), base))
        got = t_smp.radical_inverse(torch.as_tensor(n), base).numpy()
        np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32), err_msg=str(base))
    ref = np.asarray(j_smp.halton_nd(jnp.asarray(n), 5))
    got = t_smp.halton_nd(torch.as_tensor(n), 5).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("spp", [1, 4, 8, 32])
def test_bestcandidate_buckets_equal(spp):
    """The port's copy of the table, bucketed with the RandomState(11)
    top-up, equals the JAX package's buckets."""
    jw, jb = j_sam._bc_buckets(spp)
    tw, tb = t_sam._bc_buckets(spp)
    assert jw == tw
    np.testing.assert_array_equal(tb, np.asarray(jb))


def _spec_pair(name, params):
    jp, tp = JParamSet(), TParamSet()
    for kind, key, vals in params:
        jp.add(kind, key, vals)
        tp.add(kind, key, vals)
    return j_sam.make_sampler(name, jp), t_sam.make_sampler(name, tp)


SAMPLERS = {
    "halton": ("halton", [("integer", "pixelsamples", [4])]),
    "bestcandidate": ("bestcandidate", [("integer", "pixelsamples", [8])]),
    "adaptive": ("adaptive", [("integer", "minsamples", [2]), ("integer", "maxsamples", [8])]),
    "adaptive min pass": ("adaptive", [("integer", "minsamples", [4]),
                                       ("integer", "maxsamples", [16])]),
}


@pytest.mark.parametrize("which", list(SAMPLERS))
def test_camera_samples_bit_equal(which):
    """Every stream of camera_samples equals the JAX package's bit for
    bit, on a patch of a 1920-wide image that crosses the best-candidate
    tile, at seeds 0 and 1 (the adaptive second pass uses seed + 1; the
    JAX package takes seed * 0x9E3779B9 as a uint32 literal, so it
    cannot run seeds above 1)."""
    js, ts = _spec_pair(*SAMPLERS[which])
    for f in ("kind", "spp", "adaptive_min", "adaptive_max", "adaptive_method"):
        assert getattr(js, f) == getattr(ts, f), f
    if which == "adaptive min pass":
        import dataclasses

        js = dataclasses.replace(js, spp=js.adaptive_min)
        ts = dataclasses.replace(ts, spp=ts.adaptive_min)
    ys, xs = np.meshgrid(np.arange(100, 140), np.arange(1000, 1040), indexing="ij")
    px, py = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    for seed in (0, 1):
        ref = j_sam.camera_samples(js, jnp.asarray(px), jnp.asarray(py), 1920, seed)
        got = t_sam.camera_samples(ts, torch.as_tensor(px), torch.as_tensor(py), 1920, seed)
        for f in ("px", "py", "u_lens1", "u_lens2", "u_time"):
            a, b = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=f)
        np.testing.assert_array_equal(got.pixel.numpy(), np.asarray(ref.pixel))


def test_make_sampler_warnings_and_fallbacks(capsys, monkeypatch):
    """An unknown sampler warns and is lowdiscrepancy; an unknown
    adaptive method warns and is contrast; quick mode cuts the counts."""
    from pbrt_tpu_torch.core import error

    monkeypatch.setattr(error, "quiet", False)
    _, spec = _spec_pair("nonesuch", [])
    assert spec.kind == t_sam.S_LOWDISCREPANCY and spec.spp == 4
    assert 'Sampler "nonesuch" unknown' in capsys.readouterr().err
    _, spec = _spec_pair("adaptive", [("string", "method", ["nonesuch"])])
    assert spec.adaptive_method == "contrast" and spec.spp == 32
    assert 'metric "nonesuch" unknown' in capsys.readouterr().err
    tp = TParamSet()
    tp.add("integer", "pixelsamples", [16])
    assert t_sam.make_sampler("halton", tp, {"quick": True}).spp == 1
    tp = TParamSet()
    assert t_sam.make_sampler("adaptive", tp, {"quick": True}).adaptive_max == 2


def test_adaptive_vetoes_identical():
    """The contrast and shape-id masks equal the JAX package's on fixed
    inputs, including luminances on and around the contrast threshold
    and pixels that mix hits and misses."""
    rng = np.random.RandomState(3)
    n_pix, spp = 512, 4
    y = rng.gamma(2.0, 1.0, (n_pix, spp)).astype(np.float32)
    y[:64] = 1.0                                        # flat pixels: no veto
    y[64:128] = 0.0                                     # black: mean 0, no veto
    y[128:192, :3] = 1.0
    y[128:192, 3] = np.float32(3.0) + rng.randint(-4, 5, 64) * np.float32(2 ** -22)
    y[192:256] *= rng.rand(64, 1) < 0.5                 # half of them black
    y = y.ravel()
    ref = np.asarray(j_sam.adaptive_needs(jnp.asarray(y), n_pix, spp))
    got = t_sam.adaptive_needs(torch.as_tensor(y), n_pix, spp).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < n_pix
    prim = rng.randint(-1, 3, (n_pix, spp)).astype(np.int32)
    prim[:100] = prim[:100, :1]
    prim = prim.ravel()
    ref = np.asarray(j_sam.adaptive_needs_shapeid(jnp.asarray(prim), n_pix, spp))
    got = t_sam.adaptive_needs_shapeid(torch.as_tensor(prim).long(), n_pix, spp).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < n_pix


CAMERAS = {
    "orthographic": [("float", "screenwindow", [-2.0, 2.0, -1.5, 1.5])],
    "orthographic lens": [("float", "lensradius", [0.1]), ("float", "focaldistance", [3.0])],
    "environment": [],
}


@pytest.mark.parametrize("which", list(CAMERAS))
def test_camera_rays_match_jax(which):
    """Orthographic (with and without a lens) and environment rays
    within 1e-6 (absolute on unit-scale values)."""
    name = which.split()[0]
    jp, tp = JParamSet(), TParamSet()
    for kind, key, vals in CAMERAS[which]:
        jp.add(kind, key, vals)
        tp.add(kind, key, vals)
    c2w = j_tf.Transform.look_at([1, 2, -5], [0, 0.3, 0], [0, 1, 0])
    jc = j_cam.make_camera(name, jp, c2w, 48, 32)
    tc = t_cam.make_camera(name, tp, t_tf.Transform(c2w.m), 48, 32)
    assert jc.kind == tc.kind
    np.testing.assert_array_equal(tc.raster_to_camera, jc.raster_to_camera)
    rng = np.random.RandomState(4)
    u = rng.rand(5, 2000).astype(np.float32)
    u[0] *= 48
    u[1] *= 32
    jr, jw = jc.generate_rays(*(jnp.asarray(x) for x in u))
    tr, tw = tc.generate_rays(*(torch.as_tensor(x) for x in u))
    for f in ("o", "d", "tmin", "tmax", "time"):
        np.testing.assert_allclose(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_animated_transform_matches_jax():
    """Decomposition, slerped interpolation (inside and outside the
    keyframe times) and motion bounds within 1e-6."""
    a = j_tf.Transform.rotate(30, [1, 2, 3]) * j_tf.Transform.translate([1, 2, 3]) \
        * j_tf.Transform.scale(1, 2, 0.5)
    b = j_tf.Transform.rotate(100, [0, 1, 1]) * j_tf.Transform.translate([-1, 0, 3]) \
        * j_tf.Transform.scale(2, 1, 0.5)
    ja = j_tf.AnimatedTransform(a, 0.5, b, 2.0)
    ta = t_tf.AnimatedTransform(t_tf.Transform(a.m), 0.5, t_tf.Transform(b.m), 2.0)
    for f in ("T0", "R0", "S0", "T1", "R1", "S1"):
        np.testing.assert_allclose(getattr(ta, f), getattr(ja, f), rtol=0, atol=1e-12, err_msg=f)
    times = np.linspace(0.0, 2.5, 41).astype(np.float32)
    np.testing.assert_allclose(ta.interpolate(torch.as_tensor(times)).numpy(),
                               np.asarray(ja.interpolate(jnp.asarray(times))), rtol=0, atol=1e-6)
    for got, ref in zip(ta.motion_bounds([-1, -1, -1], [1, 2, 1]),
                        ja.motion_bounds([-1, -1, -1], [1, 2, 1])):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    static = t_tf.AnimatedTransform(t_tf.Transform(a.m), 0, t_tf.Transform(a.m), 1)
    assert not static.actually_animated
    np.testing.assert_allclose(static.interpolate(0.3).numpy(), a.m, atol=1e-6)
    np.testing.assert_allclose(t_tf.Transform.orthographic(0.5, 3.0).m,
                               j_tf.Transform.orthographic(0.5, 3.0).m)


def test_probe_counters():
    """count / counters / reset / print_counters, and scope as a
    torch.profiler range."""
    probes.reset()
    probes.count("render/tiles")
    probes.count("render/tiles", 2)
    probes.count("render/camera_samples", 4096)
    assert probes.counters() == {"render/tiles": 3, "render/camera_samples": 4096}
    with probes.scope("render"):
        pass
    probes.reset()
    assert probes.counters() == {}
