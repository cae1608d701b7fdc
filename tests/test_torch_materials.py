"""Materials of the port against the JAX package: every kind of
MATERIAL_KINDS, textured, through eval_bsdf_params, material_lobes,
bsdf_f, bsdf_pdf and bsdf_sample (with u3 and u_pick).

One scene file declares a material of every kind (substrate both
isotropic and anisotropic, uber with opacity < 1 and Kt > 0, metal with
the copper defaults, measured from a MERL file under tmp_path, mix and
a nested mix) on one small triangle each; both packages compile it. A
hit batch made with NumPy from a seed (points, uv, frames, material
ids, some lanes with no material) goes to both through `bridge`.

Tolerances: material slots rtol 1e-5 / atol 1e-6 (textures, see
tests/test_torch_textures.py). BSDF values rtol 1e-4 / atol 1e-6, the
tolerance of tests/test_torch_bsdf.py (pow, sin, cos, sqrt and the
30-bin luminance dot products come from different libraries and the
Blinn and anisotropic exponents amplify a few ulp); the BSDF functions
get the JAX package's own slots (bsdf_from_arrays), so each stage is
held on its own. Flags (is_specular, did_transmit, valid) must be
identical.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.accel.intersect import Hit as JHit
from pbrt_tpu.materials import bsdf as jb
from pbrt_tpu.materials import measured as j_meas
from pbrt_tpu.materials.registry import MATERIAL_KINDS
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.scene.compile import eval_bsdf_params as j_eval
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import error as t_error
from pbrt_tpu_torch.materials import bsdf as tb
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from pbrt_tpu_torch.scene.compile import eval_bsdf_params as t_eval
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

H = 4096


def write_const_merl(path, rgb=(0.3, 0.5, 0.2)):
    """A constant MERL binary file (as tests/test_measured.py writes one)."""
    n = j_meas.TH * j_meas.TD * j_meas.PD
    scale = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0])
    with open(path, "wb") as f:
        np.array([j_meas.TH, j_meas.TD, j_meas.PD], np.int32).tofile(f)
        np.concatenate([np.full(n, rgb[c] / scale[c], np.float64) for c in range(3)]).tofile(f)


TEXTURES = ('Texture "chk" "color" "checkerboard" "rgb tex1" [.7 .2 .1] "rgb tex2" [.1 .4 .6] '
            '"float uscale" [4] "float vscale" [4]\n'
            'Texture "rough" "float" "wrinkled" "integer octaves" [4]\n'
            'Texture "r2" "float" "mix" "float tex1" [.05] "float tex2" [.25] '
            '"texture amount" "rough"\n'
            'Texture "amt" "color" "dots" "rgb inside" [.9 .8 .7] "rgb outside" [.2 .3 .1] '
            '"float uscale" [3] "float vscale" [3]\n')


def materials(merl):
    """kind label -> Material / MakeNamedMaterial lines."""
    return {
        "matte": 'Material "matte" "texture Kd" "chk" "float sigma" [20]',
        "plastic": 'Material "plastic" "texture Kd" "chk" "texture roughness" "r2"',
        "translucent": 'Material "translucent" "texture Kd" "chk" "rgb reflect" [.6 .5 .4] '
                       '"rgb transmit" [.3 .4 .5] "float roughness" [.05]',
        "glass": 'Material "glass" "float index" [1.6] "float Vn" [40]',
        "mirror": 'Material "mirror" "texture Kr" "chk"',
        "metal": 'Material "metal" "float roughness" [.08]',
        "substrate_iso": 'Material "substrate" "texture Kd" "chk" "rgb Ks" [.1 .1 .1]',
        "substrate_aniso": 'Material "substrate" "rgb Kd" [.5 .3 .2] "rgb Ks" [.2 .2 .2] '
                           '"float uroughness" [.02] "float vroughness" [.3]',
        "uber": 'Material "uber" "texture Kd" "chk" "rgb Kr" [.1 .1 .1] "rgb Kt" [.3 .3 .3] '
                '"rgb opacity" [.6 .7 .8] "float index" [1.3]',
        "shinymetal": 'Material "shinymetal" "rgb Ks" [.8 .6 .4] "rgb Kr" [.3 .5 .7] '
                      '"texture roughness" "r2"',
        "measured": f'Material "measured" "string filename" "{merl}"',
        "subsurface": 'Material "subsurface" "string name" "Ketchup" "rgb Kr" [.8 .8 .8]',
        "kdsubsurface": 'Material "kdsubsurface" "texture Kd" "chk" "float meanfreepath" [.5]',
        "mix": 'MakeNamedMaterial "ma" "string type" "plastic" "rgb Kd" [.6 .1 .1]\n'
               'MakeNamedMaterial "mb" "string type" "metal"\n'
               'Material "mix" "string namedmaterial1" "ma" "string namedmaterial2" "mb" '
               '"texture amount" "amt"',
        "mix_nested": 'MakeNamedMaterial "ma" "string type" "plastic" "rgb Kd" [.6 .1 .1]\n'
                      'MakeNamedMaterial "mb" "string type" "metal"\n'
                      'MakeNamedMaterial "mc" "string type" "mix" "string namedmaterial1" "ma" '
                      '"string namedmaterial2" "mb" "float amount" [.3]\n'
                      'MakeNamedMaterial "md" "string type" "glass"\n'
                      'Material "mix" "string namedmaterial1" "mc" "string namedmaterial2" "md" '
                      '"float amount" [.6]',
    }


def scene_text(merl, labels):
    s = ('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
         'LookAt 0 0 -5 0 0 0 0 1 0\nCamera "perspective"\nWorldBegin\n'
         'LightSource "point" "point from" [0 3 -3] "rgb I" [10 10 10]\n' + TEXTURES)
    mats = materials(merl)
    for k, label in enumerate(labels):
        x = float(k)
        s += (f"AttributeBegin\n{mats[label]}\n"
              f'Shape "trianglemesh" "integer indices" [0 1 2] "point P" '
              f"[{x} 0 0 {x + 0.5} 0 0 {x} 0.5 0]\nAttributeEnd\n")
    return s + "WorldEnd\n"


def random_hits(n_mats, seed):
    rng = np.random.RandomState(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    ns = unit(rng.normal(size=(H, 3)))
    dpdu = unit(np.cross(ns, rng.normal(size=(H, 3))) * rng.uniform(0.5, 2, (H, 1)))
    mat = rng.randint(-1, n_mats, H)
    return {
        "hit.valid": np.ones(H, bool), "hit.t": rng.uniform(1, 5, H).astype(np.float32),
        "hit.p": rng.uniform(-2, 2, (H, 3)).astype(np.float32),
        "hit.ng": unit(ns + 0.2 * rng.normal(size=(H, 3))), "hit.ns": ns,
        "hit.uv": rng.uniform(-1, 2, (H, 2)).astype(np.float32), "hit.dpdu": dpdu,
        "hit.mat": mat.astype(np.int32), "hit.light": np.full(H, -1, np.int32),
        "hit.prim": np.maximum(mat, 0).astype(np.int32),
    }


def frames_and_dirs(hits, seed):
    rng = np.random.RandomState(seed)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)

    ns = hits["hit.ns"]
    ss = unit(np.cross(ns, rng.normal(size=(H, 3))))
    frame = {"ss": ss, "ts": np.cross(ns, ss).astype(np.float32), "ns": ns,
             "ng": hits["hit.ng"]}
    wo = unit(rng.normal(size=(H, 3)))
    wi = unit(rng.normal(size=(H, 3)))
    flip = (rng.rand(H) < 0.6) & (np.sum(wo * ns, -1) * np.sum(wi * ns, -1) < 0)
    wi[flip] -= 2 * np.sum(wi[flip] * ns[flip], -1, keepdims=True) * ns[flip]
    u = (rng.randint(0, 1 << 24, (6, H)) / float(1 << 24)).astype(np.float32)
    lam = np.where(rng.rand(H) < 0.5, -1.0, rng.uniform(400, 700, H)).astype(np.float32)
    return frame, wo, wi, u, lam


ALL = tuple(materials("x"))
NO_MIX = tuple(k for k in ALL if not k.startswith("mix"))


@pytest.fixture(scope="module", params=["all", "no_mix"])
def case(request, tmp_path_factory):
    d = tmp_path_factory.mktemp("mats")
    merl = d / "const.binary"
    write_const_merl(str(merl))
    labels = ALL if request.param == "all" else NO_MIX
    path = d / "mats.pbrt"
    path.write_text(scene_text(merl, labels))
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    hits = random_hits(len(ts.materials), seed=21)
    jhit = JHit(**{f: jnp.asarray(hits[f"hit.{f}"]) for f in JHit._fields})
    thit = bridge.hit_from_arrays(hits, "cpu")
    jp, tp = j_eval(js, jhit), t_eval(ts, thit)
    return request.param, js, ts, hits, jp, tp


def _cmp(got: dict, ref: dict, rtol, atol):
    assert set(got) == set(ref)
    for key in sorted(ref):
        g, r = got[key], ref[key]
        if g.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r.astype(g.dtype), err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=key)


def test_every_kind_compiles(case):
    name, js, ts, _, _, _ = case
    kinds = {m.kind for m in ts.materials}
    expected = set(MATERIAL_KINDS) - {"none"} - ({"mix"} if name == "no_mix" else set())
    assert kinds == expected
    assert [m.kind for m in ts.materials] == [m.kind for m in js.materials]
    assert ts.meas_tables.shape == (1, j_meas.TH, j_meas.TD, j_meas.PD, 3)
    np.testing.assert_array_equal(ts.meas_tables.numpy(), np.asarray(js.meas_tables))


def test_eval_bsdf_params_matches(case):
    _, _, _, _, jp, tp = case
    _cmp(bridge.tuple_to_arrays(tp, "params"), bridge.tuple_to_arrays(jp, "params"),
         1e-5, 1e-6)


def test_material_lobes_match(case):
    _, _, _, _, jp, _ = case
    arrays = bridge.tuple_to_arrays(jp, "params")
    ref = jb.material_lobes(jp)
    got = tb.material_lobes(bridge.bsdf_from_arrays(arrays, "cpu"))
    _cmp(bridge.tuple_to_arrays(got, "lobes"), bridge.tuple_to_arrays(ref, "lobes"), 1e-5, 1e-6)
    for fn in ("has_transmissive", "has_specular", "has_non_specular"):
        np.testing.assert_array_equal(getattr(tb, fn)(got).numpy(),
                                      np.asarray(getattr(jb, fn)(ref)), err_msg=fn)
    for g, r in zip(tb.rho_proxies(got), jb.rho_proxies(ref)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def lobes(case):
    name, _, _, hits, jp, _ = case
    ref = jb.material_lobes(jp)
    got = tb.material_lobes(bridge.bsdf_from_arrays(bridge.tuple_to_arrays(jp, "params"),
                                                    "cpu"))
    frame, wo, wi, u, lam = frames_and_dirs(hits, seed=22)
    jf = jb.Frame(**{k: jnp.asarray(v) for k, v in frame.items()})
    tf = tb.Frame(**{k: torch.as_tensor(v) for k, v in frame.items()})
    return name, hits, ref, got, jf, tf, wo, wi, u, lam


def test_bsdf_f_and_pdf_match(lobes):
    _, hits, ref, got, jf, tf, wo, wi, _, _ = lobes
    f_ref = np.asarray(jb.bsdf_f(ref, jf, jnp.asarray(wo), jnp.asarray(wi)))
    f = tb.bsdf_f(got, tf, torch.as_tensor(wo), torch.as_tensor(wi)).numpy()
    assert (f > 0).any(-1).mean() > 0.2
    np.testing.assert_allclose(f, f_ref, rtol=1e-4, atol=1e-6)
    p_ref = np.asarray(jb.bsdf_pdf(ref, jf, jnp.asarray(wo), jnp.asarray(wi)))
    p = tb.bsdf_pdf(got, tf, torch.as_tensor(wo), torch.as_tensor(wi)).numpy()
    np.testing.assert_allclose(p, p_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("with_u3", [True, False])
def test_bsdf_sample_matches(lobes, with_u3):
    """With the independent u3 / u_pick dimensions, and with the
    fallback scrambles of u_lobe the JAX package uses without them."""
    name, hits, ref, got, jf, tf, wo, _, u, lam = lobes
    ju = [jnp.asarray(x) for x in u]
    tu = [torch.as_tensor(x) for x in u]
    extra_j = dict(u_pick=ju[4]) if with_u3 else {}
    extra_t = dict(u_pick=tu[4]) if with_u3 else {}
    r = jb.bsdf_sample(ref, jf, jnp.asarray(wo), ju[0], ju[1], ju[2],
                       ju[3] if with_u3 else None, lam_nm=jnp.asarray(lam), **extra_j)
    g = tb.bsdf_sample(got, tf, torch.as_tensor(wo), tu[0], tu[1], tu[2],
                       tu[3] if with_u3 else None, lam_nm=torch.as_tensor(lam), **extra_t)
    for flag in ("is_specular", "did_transmit", "valid"):
        np.testing.assert_array_equal(getattr(g, flag).numpy(), np.asarray(getattr(r, flag)),
                                      err_msg=flag)
    assert np.asarray(r.valid).mean() > 0.5
    assert np.asarray(r.did_transmit).sum() > 50
    for field in ("wi", "f", "pdf"):
        np.testing.assert_allclose(getattr(g, field).numpy(), np.asarray(getattr(r, field)),
                                   rtol=1e-4, atol=1e-6, err_msg=field)
    # every material drew valid samples
    mat = hits["hit.mat"]
    for m in range(mat.max() + 1):
        assert np.asarray(r.valid)[mat == m].any(), m


def test_nested_mix_warns(tmp_path, capsys, monkeypatch):
    """A nested mix flattens to its first constituent, with the JAX
    package's warning."""
    merl = tmp_path / "c.binary"
    path = tmp_path / "m.pbrt"
    path.write_text(scene_text(merl, ("mix_nested",)))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    monkeypatch.setattr(t_error, "quiet", False)
    capsys.readouterr()
    hits = random_hits(1, seed=3)
    p = t_eval(ts, bridge.hit_from_arrays(hits, "cpu"))
    assert "nested mix materials flatten" in capsys.readouterr().err
    assert p.mix2 is not None
