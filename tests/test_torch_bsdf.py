"""Parts of the path against the JAX package: BSDF evaluation and
sampling for the four ported materials, and light sampling.

Random materials, shading frames, directions and uniforms (NumPy,
seeded) go to both packages. Tolerances: rtol 1e-4 / atol 1e-6 on
values — pow, sin, cos, sqrt and the 30-bin luminance dot product are
computed by different libraries (XLA vs ATen) and differ by a few ulp,
which the Blinn exponent (up to 100) amplifies. Discrete outputs (lobe
flags, validity) must agree on all but 0.1% of lanes: a lane may flip
only when its uniform falls within an ulp of a lobe CDF boundary.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.lights import lighting as jl
from pbrt_tpu.materials import bsdf as jb
from pbrt_tpu_torch.lights import lighting as tl
from pbrt_tpu_torch.materials import bsdf as tb
from pbrt_tpu_torch.materials.registry import KIND_ID

H = 4096
S = 30


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _uniform(rng, *shape):
    return (rng.randint(0, 1 << 24, shape) / float(1 << 24)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(11)
    kinds = np.array([KIND_ID[k] for k in ("matte", "plastic", "mirror", "glass")])
    kind = kinds[rng.randint(0, 4, H)]
    spec = lambda: rng.uniform(0, 1, (H, S)).astype(np.float32)  # noqa: E731
    p = dict(
        kind=kind.astype(np.int32), kd=spec(), ks=spec(), kr=spec(), kt=spec(),
        rough_u=rng.uniform(0.01, 0.5, H).astype(np.float32),
        eta=rng.uniform(1.3, 1.8, H).astype(np.float32),
        vn=np.where(rng.rand(H) < 0.5, 0.0, rng.uniform(20, 60, H)).astype(np.float32),
        sigma=np.where(rng.rand(H) < 0.5, 0.0, rng.uniform(0, 30, H)).astype(np.float32),
    )
    ns = _unit(rng.normal(size=(H, 3)))
    ss = _unit(np.cross(ns, rng.normal(size=(H, 3))))
    ts = np.cross(ns, ss).astype(np.float32)
    ng = _unit(ns + 0.2 * rng.normal(size=(H, 3)))
    frame = dict(ss=ss, ts=ts, ns=ns, ng=ng)
    wo = _unit(rng.normal(size=(H, 3)))
    wi = _unit(rng.normal(size=(H, 3)))
    # half the wi on wo's side of the surface, so reflection lobes count
    flip = (rng.rand(H) < 0.5) & (np.sum(wo * ns, -1) * np.sum(wi * ns, -1) < 0)
    wi[flip] -= 2 * np.sum(wi[flip] * ns[flip], -1, keepdims=True) * ns[flip]
    u = _uniform(rng, 4, H)
    lam = np.where(rng.rand(H) < 0.5, -1.0, rng.uniform(400, 700, H)).astype(np.float32)
    return p, frame, wo, wi, u, lam


def _both(inputs):
    p, frame, wo, wi, u, lam = inputs
    z = np.zeros((H, S), np.float32)
    jp = jb.BsdfParams(kind=jnp.asarray(p["kind"]), kd=jnp.asarray(p["kd"]),
                       ks=jnp.asarray(p["ks"]), kr=jnp.asarray(p["kr"]),
                       kt=jnp.asarray(p["kt"]), opacity=jnp.asarray(z + 1),
                       rough_u=jnp.asarray(p["rough_u"]), rough_v=jnp.asarray(p["rough_u"]),
                       eta=jnp.asarray(p["eta"]), vn=jnp.asarray(p["vn"]),
                       sigma=jnp.asarray(p["sigma"]))
    tp = tb.BsdfParams(**{k: torch.as_tensor(v) for k, v in p.items()})
    tp = tp._replace(kind=tp.kind.long())
    jf = jb.Frame(**{k: jnp.asarray(v) for k, v in frame.items()})
    tf = tb.Frame(**{k: torch.as_tensor(v) for k, v in frame.items()})
    return jb.material_lobes(jp), jf, tb.material_lobes(tp), tf


def _close(got, ref, name):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-6,
                               err_msg=name)


def test_bsdf_f_and_pdf(inputs):
    _, _, wo, wi, _, _ = inputs
    jlb, jf, tlb, tf = _both(inputs)
    f_ref = jb.bsdf_f(jlb, jf, jnp.asarray(wo), jnp.asarray(wi))
    f = tb.bsdf_f(tlb, tf, torch.as_tensor(wo), torch.as_tensor(wi))
    assert (f.numpy() > 0).any(-1).mean() > 0.2
    _close(f, f_ref, "bsdf_f")
    pdf_ref = jb.bsdf_pdf(jlb, jf, jnp.asarray(wo), jnp.asarray(wi))
    pdf = tb.bsdf_pdf(tlb, tf, torch.as_tensor(wo), torch.as_tensor(wi))
    _close(pdf, pdf_ref, "bsdf_pdf")


def test_bsdf_sample(inputs):
    _, _, wo, _, u, lam = inputs
    jlb, jf, tlb, tf = _both(inputs)
    ref = jb.bsdf_sample(jlb, jf, jnp.asarray(wo), *(jnp.asarray(x) for x in u[:3]),
                         jnp.asarray(u[3]), lam_nm=jnp.asarray(lam))
    got = tb.bsdf_sample(tlb, tf, torch.as_tensor(wo), *(torch.as_tensor(x) for x in u[:3]),
                         lam_nm=torch.as_tensor(lam))
    flags = ("is_specular", "did_transmit", "valid")
    same = np.ones(H, bool)
    for name in flags:
        same &= getattr(got, name).numpy() == np.asarray(getattr(ref, name))
    assert same.mean() >= 0.999
    assert np.asarray(ref.did_transmit).sum() > 100
    for name in ("wi", "f", "pdf"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(ref, name))[same],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_sample_light_point_and_area():
    rng = np.random.RandomState(12)
    l2w = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    l2w[0, :3, 3] = [1.0, 4.0, -2.0]
    v0 = np.array([[-1, 3, -1], [-1, 3, -1]], np.float32)
    e1 = np.array([[2, 0, 2], [2, 0, 0]], np.float32)
    e2 = np.array([[2, 0, 0], [0, 0, 2]], np.float32)
    params = np.zeros((2, 12), np.float32)
    params[1, [0, 6, 7]] = [4.0, 0, 2]
    arrays = dict(kind=np.array([0, 6], np.int32), l2w=l2w, w2l=np.linalg.inv(l2w),
                  spectra=rng.uniform(1, 5, (2, S)).astype(np.float32), params=params,
                  power=np.ones((2, S), np.float32), n_samples=np.ones(2, np.int32),
                  al_v0=v0, al_e1=e1, al_e2=e2, al_cdf=np.array([0.5, 1.0], np.float32))
    jlights = jl.LightsT(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tlights = tl.LightsT(**{k: torch.as_tensor(v) for k, v in arrays.items()})
    idx = rng.randint(0, 2, H).astype(np.int32)
    p = rng.uniform(-2, 2, (H, 3)).astype(np.float32)
    u1, u2 = _uniform(rng, 2, H)
    ref = jl.sample_light(jlights, [], jnp.asarray(idx), jnp.asarray(p), jnp.asarray(u1),
                          jnp.asarray(u2))
    got = tl.sample_light(tlights, torch.as_tensor(idx), torch.as_tensor(p),
                          torch.as_tensor(u1), torch.as_tensor(u2))
    np.testing.assert_array_equal(got.is_delta.numpy(), np.asarray(ref.is_delta))
    wi = _unit(rng.normal(size=(H, 3)))
    _close(tl.light_pdf(tlights, torch.as_tensor(idx), torch.as_tensor(p), torch.as_tensor(wi)),
           jl.light_pdf(jlights, [], jnp.asarray(idx), jnp.asarray(p), jnp.asarray(wi)),
           "light_pdf")
    for name in ("L", "wi", "pdf", "dist"):
        _close(getattr(got, name), getattr(ref, name), name)
    ng = _unit(rng.normal(size=(H, 3)))
    wo = _unit(rng.normal(size=(H, 3)))
    _close(tl.area_emission(tlights, torch.as_tensor(idx), torch.as_tensor(ng),
                            torch.as_tensor(wo)),
           jl.area_emission(jlights, jnp.asarray(idx), jnp.asarray(ng), jnp.asarray(wo)),
           "area_emission")
    d2, cos = rng.uniform(0.1, 9, H).astype(np.float32), rng.uniform(-1, 1, H).astype(np.float32)
    _close(tl.area_tri_pdf(tlights, torch.as_tensor(idx), torch.as_tensor(d2),
                           torch.as_tensor(cos)),
           jl.area_tri_pdf(jlights, jnp.asarray(idx), jnp.asarray(d2), jnp.asarray(cos)),
           "area_tri_pdf")
