"""Textures of the port against the JAX package.

Every texture class and mapping is declared by `Texture` statements in
one scene file, which both packages parse; each pair of textures is
evaluated on the same ShadingGeom (NumPy, seeded: points, uv beyond
[0, 1] so the wraps matter, and nonzero differentials so the closed-form
checkerboard filters and trilinear / EWA lookups pick real mip levels).

Tolerances: values within rtol 1e-5, atol 1e-6 (XLA's CPU backend
contracts multiply-adds into FMAs that ATen rounds separately).
Quantities decided by integer lattice or texel indices (checkerboard
parity, dots membership, texel-centre lookups) must match exactly. The
spherical and cylindrical mappings are held on textures that do not
read differentials: their finite-difference differentials amplify the
rounding differences by 1/delta.

Also here: the port's versions of tests/test_texture_files.py and
tests/test_texture_filter.py (file round trips through a render, the
white texel of a missing file, EWA vs trilinear).
"""
import os
import textwrap

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.textures import noise as j_noise
from pbrt_tpu.textures import registry as jt
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import error as t_error
from pbrt_tpu_torch.io.image import read_image, write_image
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.textures import noise as t_noise
from pbrt_tpu_torch.textures import registry as tt

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

H = 2048
RTOL, ATOL = 1e-5, 1e-6


def _sg_arrays(seed=0, h=H, diff_scale=(1e-3, 0.5)):
    rng = np.random.RandomState(seed)
    lo, hi = diff_scale
    mag = lambda n: np.exp(rng.uniform(np.log(lo), np.log(hi), (h, 1)))  # noqa: E731
    return {
        "sg.p": rng.uniform(-3, 3, (h, 3)).astype(np.float32),
        "sg.uv": rng.uniform(-1.5, 2.5, (h, 2)).astype(np.float32),
        "sg.dpdx": (rng.normal(size=(h, 3)) * mag(3)).astype(np.float32),
        "sg.dpdy": (rng.normal(size=(h, 3)) * mag(3)).astype(np.float32),
        "sg.duvdx": (rng.normal(size=(h, 2)) * mag(2)).astype(np.float32),
        "sg.duvdy": (rng.normal(size=(h, 2)) * mag(2)).astype(np.float32),
    }


def _both_sg(arrays):
    jsg = jt.ShadingGeom(*(jnp.asarray(arrays[f"sg.{f}"]) for f in jt.ShadingGeom._fields))
    return jsg, bridge.shading_geom_from_arrays(arrays, "cpu")


def _textures(api, parser, path):
    """(float textures, spectrum textures) a scene file declares."""
    api.pbrt_init({"quiet": True})
    try:
        parser.parse_file(str(path))
        gs = api._state.graphics_state
        return dict(gs.float_textures), dict(gs.spectrum_textures)
    finally:
        api._state.__init__()


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(0.0, 1.0, (h, w, 3)).astype(np.float32)


CONST = ('Texture "c1" "float" "constant" "float value" [0.3]\n'
         'Texture "c2" "float" "constant" "float value" [0.8]\n'
         'Texture "s1" "color" "constant" "rgb value" [.8 .2 .1]\n'
         'Texture "s2" "color" "constant" "rgb value" [.1 .3 .9]\n')

# name -> (type, declaration after "Texture <name> <type>")
DECLS = {
    "const_f": ("float", '"constant" "float value" [0.7]'),
    "const_s": ("color", '"constant" "rgb value" [.2 .5 .7]'),
    "scale_f": ("float", '"scale" "texture tex1" "c1" "float tex2" [2.5]'),
    "scale_s": ("color", '"scale" "texture tex1" "s1" "texture tex2" "s2"'),
    "mix_s": ("color", '"mix" "texture tex1" "s1" "texture tex2" "s2" "texture amount" "fbm"'),
    "bilerp_f": ("float", '"bilerp" "float v00" [.1] "float v01" [.9] "float v10" [.4] '
                          '"float v11" [.6] "float uscale" [2] "float vdelta" [.3]'),
    "bilerp_s": ("color", '"bilerp" "rgb v00" [1 0 0] "rgb v11" [0 0 1] "string mapping" '
                          '"spherical"'),
    "uv_s": ("color", '"uv" "string mapping" "cylindrical"'),
    "uv_planar": ("color", '"uv" "string mapping" "planar" "vector v1" [1 .5 0] '
                           '"vector v2" [0 .3 1] "float udelta" [.2]'),
    "check_cf": ("color", '"checkerboard" "texture tex1" "s1" "texture tex2" "s2" '
                          '"float uscale" [4] "float vscale" [3]'),
    "check_cf_f": ("float", '"checkerboard" "texture tex1" "c1" "texture tex2" "c2" '
                            '"float udelta" [.25]'),
    "check_none": ("float", '"checkerboard" "float tex1" [0] "float tex2" [1] '
                            '"string aamode" "none" "float uscale" [5] "float vscale" [5]'),
    "check_3d": ("float", '"checkerboard" "integer dimension" [3] "float tex1" [0] '
                          '"float tex2" [1]'),
    "dots_f": ("float", '"dots" "float inside" [1] "float outside" [0] "float uscale" [6] '
                        '"float vscale" [6]'),
    "dots_s": ("color", '"dots" "texture inside" "s1" "texture outside" "s2" '
                        '"float uscale" [4] "float vscale" [4]'),
    "fbm": ("float", '"fbm" "integer octaves" [6] "float roughness" [.6]'),
    "wrinkled": ("float", '"wrinkled"'),
    "windy": ("float", '"windy"'),
    "marble": ("color", '"marble" "float scale" [2.5] "float variation" [.5]'),
}
EXACT = ("check_none", "check_3d", "dots_f")


@pytest.fixture(scope="module")
def declared(tmp_path_factory):
    d = tmp_path_factory.mktemp("tex")
    img = _image(48, 48, seed=4)           # 48 -> 24 -> 12 -> 6 -> 3 -> 1: an odd level
    for ext in ("pfm", "tga", "png"):
        write_image(str(d / f"img.{ext}"), img)
    decls = dict(DECLS)
    for wrap in ("repeat", "clamp", "black"):
        for filt, tri in (("ewa", "false"), ("tri", "true")):
            decls[f"img_{wrap}_{filt}"] = (
                "color", f'"imagemap" "string filename" "{d}/img.pfm" "string wrap" "{wrap}" '
                         f'"bool trilinear" "{tri}" "float uscale" [1.5]')
    decls["img_tga_gamma"] = ("color", f'"imagemap" "string filename" "{d}/img.tga"')
    decls["img_png_gamma_f"] = ("float", f'"imagemap" "string filename" "{d}/img.png" '
                                         '"float gamma" [1.8] "float scale" [.7] '
                                         '"float maxanisotropy" [3]')
    decls["img_missing"] = ("color", f'"imagemap" "string filename" "{d}/missing.tga"')
    text = "WorldBegin\n" + CONST + 'Texture "fbm" "float" "fbm"\n'
    text += "TransformBegin\nRotate 30 1 1 0\nTranslate .3 -.2 .5\nScale 1.2 .8 1\n"
    for name, (ttype, decl) in decls.items():
        text += f'Texture "{name}" "{ttype}" {decl}\n'
    text += "TransformEnd\n"
    path = d / "textures.pbrt"
    path.write_text(text)
    jf, js = _textures(j_api, j_parser, path)
    tf, ts = _textures(t_api, t_parser, path)
    jsg, tsg = _both_sg(_sg_arrays())
    out = {}
    for name, (ttype, _) in decls.items():
        jd, td = (jf, tf) if ttype == "float" else (js, ts)
        out[name] = (jd[name], td[name], np.asarray(jd[name].eval(jsg)),
                     td[name].eval(tsg).numpy())
    return out


def test_every_texture_class_is_reachable(declared):
    """Each class of the JAX package's registry comes out of a Texture
    statement in the port, as the same class."""
    classes = {type(t).__name__ for _, t, _, _ in declared.values()}
    expected = {c.__name__ for c in (
        jt.ConstantTexture, jt.ScaleTexture, jt.MixTexture, jt.BilerpTexture, jt.UVTexture,
        jt.CheckerboardTexture2D, jt.CheckerboardTexture3D, jt.DotsTexture, jt.FBmTexture,
        jt.WrinkledTexture, jt.WindyTexture, jt.MarbleTexture, jt.ImageMapTexture)}
    assert classes == expected
    for name, (j, t, _, _) in declared.items():
        assert type(t).__name__ == type(j).__name__, name
        assert t.spectral == j.spectral, name


@pytest.mark.parametrize("name", sorted(DECLS) + [
    f"img_{w}_{f}" for w in ("repeat", "clamp", "black") for f in ("ewa", "tri")] + [
    "img_tga_gamma", "img_png_gamma_f", "img_missing"])
def test_texture_matches_jax(declared, name):
    _, _, ref, got = declared[name]
    assert got.shape == ref.shape == ((H, 30) if ref.ndim == 2 else (H,))
    assert np.isfinite(got).all()
    if name in EXACT:
        np.testing.assert_array_equal(got, ref)
        assert 0.05 < got.mean() < 0.95
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if name == "img_missing":       # one white texel (reference imagemap.cpp:78-80)
        assert declared[name][1].levels[0].shape == (1, 1, 3)
        np.testing.assert_allclose(got, np.asarray(jt.spec.from_rgb(np.ones(3, np.float32)))[None]
                                   .repeat(H, 0), rtol=1e-5)


def test_lookups_pick_several_mip_levels(declared):
    """The differentials above make trilinear and EWA read more than the
    finest level (what the comparison must cover), and the pyramid is
    the JAX package's, level for level."""
    j, t, _, _ = declared["img_repeat_tri"]
    assert len(t.levels) == len(j.levels) == 6
    for lt, lj in zip(t.levels, j.levels):
        np.testing.assert_array_equal(lt, np.asarray(lj))
    _, _, dsdx, dtdx, dsdy, dtdy = t.mapping.map(_both_sg(_sg_arrays())[1])
    width = torch.maximum(torch.maximum(dsdx.abs(), dtdx.abs()),
                          torch.maximum(dsdy.abs(), dtdy.abs()))
    lvl = torch.clamp(len(t.levels) - 1 + torch.log2(width), 0, len(t.levels) - 1)
    assert len(set(torch.floor(lvl).long().tolist())) >= 4


def test_non_square_pyramid_halves_the_long_side_alone():
    """Past the point where the short side is one texel, the long side
    keeps halving (1x2 means) down to a single texel."""
    img = _image(5, 32, seed=6)
    levels = tt.ImageMapTexture._build_pyramid(img)
    assert [lv.shape[:2] for lv in levels] == [(5, 32), (2, 16), (1, 8), (1, 4), (1, 2),
                                               (1, 1)]
    np.testing.assert_allclose(levels[2][0, 0], img[:4, :4].mean((0, 1)), rtol=1e-6)
    np.testing.assert_allclose(levels[-1][0, 0], img[:4].mean((0, 1)), rtol=1e-5)


@pytest.mark.parametrize("wrap", ["repeat", "clamp", "black"])
def test_texel_indices_match_exactly(wrap):
    """An image whose texels hold their own index, read at texel centres
    (zero differentials: level 0, no blending) through each wrap, gives
    the JAX package's values bit for bit, so the texel indices agree."""
    h, w = 32, 32
    idx = np.arange(h * w, dtype=np.float32).reshape(h, w)
    img = np.repeat(idx[..., None], 3, -1)
    key = f"__index_{wrap}__"
    jt.ImageMapTexture._cache[(key, 1.0)] = img
    tt.ImageMapTexture._cache[(key, 1.0)] = img
    jtex = jt.ImageMapTexture(jt.UVMapping2D(), key, False, trilinear=True, wrap=wrap)
    ttex = tt.ImageMapTexture(tt.UVMapping2D(), key, False, trilinear=True, wrap=wrap)
    rng = np.random.RandomState(9)
    i = rng.randint(-2 * w, 3 * w, 512)
    j = rng.randint(-2 * h, 3 * h, 512)
    uv = np.stack([(i + 0.5) / w, (j + 0.5) / h], -1).astype(np.float32)
    p = np.zeros((512, 3), np.float32)
    ref = np.asarray(jtex.eval(jt.ShadingGeom.at(jnp.asarray(p), jnp.asarray(uv))))
    got = ttex.eval(tt.ShadingGeom.at(torch.as_tensor(p), torch.as_tensor(uv))).numpy()
    np.testing.assert_array_equal(got, ref)
    inside = (i >= 0) & (i < w) & (j >= 0) & (j < h)
    np.testing.assert_array_equal(got[inside], idx[j[inside], i[inside]])


def test_render_time_lookups_point_sample():
    """ShadingGeom.at, what the integrators pass, has zero differentials
    in both packages: the EWA and trilinear lookups read only the finest
    level (bilinear at the point), and the closed-form checkerboard
    equals the unfiltered one."""
    rng = np.random.RandomState(10)
    img = rng.uniform(0, 1, (64, 64, 3)).astype(np.float32)
    uv = rng.uniform(-1, 2, (512, 2)).astype(np.float32)
    p = np.zeros((512, 3), np.float32)
    for pkg, sg in ((jt, jt.ShadingGeom.at(jnp.asarray(p), jnp.asarray(uv))),
                    (tt, tt.ShadingGeom.at(torch.as_tensor(p), torch.as_tensor(uv)))):
        pkg.ImageMapTexture._cache[("__point__", 1.0)] = img
        ewa = pkg.ImageMapTexture(pkg.UVMapping2D(), "__point__", True, trilinear=False)
        tri = pkg.ImageMapTexture(pkg.UVMapping2D(), "__point__", True, trilinear=True)
        np.testing.assert_allclose(np.asarray(ewa.eval(sg)), np.asarray(tri.eval(sg)),
                                   rtol=1e-6, atol=1e-7)
        c1, c2 = pkg.ConstantTexture(np.float32(0.0)), pkg.ConstantTexture(np.float32(1.0))
        cf = pkg.CheckerboardTexture2D(pkg.UVMapping2D(4, 4), c1, c2, "closedform")
        none = pkg.CheckerboardTexture2D(pkg.UVMapping2D(4, 4), c1, c2, "none")
        np.testing.assert_array_equal(np.asarray(cf.eval(sg)), np.asarray(none.eval(sg)))
    # the finest level, bilinear: a texel centre reads its texel
    centre = torch.as_tensor([[(5 + 0.5) / 64, (9 + 0.5) / 64]], dtype=torch.float32)
    got = tri.eval(tt.ShadingGeom.at(torch.zeros((1, 3)), centre))
    np.testing.assert_allclose(got.numpy()[0], np.asarray(
        tt.spec.from_rgb(img[9, 5][None]))[0], rtol=1e-5)


def test_noise_lattice_and_octaves_match():
    """The permutation table is the JAX package's exactly; noise, fbm and
    turbulence agree on points spread over many lattice cells."""
    np.testing.assert_array_equal(t_noise.NOISE_PERM, np.asarray(j_noise.NOISE_PERM))
    rng = np.random.RandomState(5)
    p = rng.uniform(-40, 40, (H, 3)).astype(np.float32)
    dl = np.exp(rng.uniform(-8, 0, H)).astype(np.float32)
    jp, tp = jnp.asarray(p), torch.as_tensor(p)
    np.testing.assert_allclose(t_noise.noise(tp).numpy(), np.asarray(j_noise.noise(jp)),
                               rtol=RTOL, atol=ATOL)
    for name in ("fbm", "turbulence"):
        ref = getattr(j_noise, name)(jp, jnp.asarray(dl), jnp.asarray(0.5 * dl), 0.5, 8)
        got = getattr(t_noise, name)(tp, torch.as_tensor(dl), torch.as_tensor(0.5 * dl), 0.5, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def test_unknown_texture_class_warns_and_is_skipped(tmp_path, capsys, monkeypatch):
    """An unknown class warns and defines nothing, as in the JAX package."""
    monkeypatch.setattr(t_error, "quiet", False)
    path = tmp_path / "s.pbrt"
    path.write_text('WorldBegin\nTexture "n" "color" "nonesuch"\n')
    t_api.pbrt_init({})
    try:
        t_parser.parse_file(str(path))
        assert "n" not in t_api._state.graphics_state.spectrum_textures
    finally:
        t_api._state.__init__()
    assert 'Texture "nonesuch" unknown' in capsys.readouterr().err


# ---------------------------------------------------------------------------
# The port's versions of tests/test_texture_files.py and
# tests/test_texture_filter.py

def _render_plane_with_texture(tmp_path, tex_filename):
    """Head-on view of a textured quad filling the image."""
    scene = tmp_path / "tex.pbrt"
    scene.write_text(textwrap.dedent(f"""
    Film "image" "integer xresolution" [32] "integer yresolution" [32]
    Sampler "lowdiscrepancy" "integer pixelsamples" [1]
    LookAt 0 0 -3  0 0 0  0 1 0
    Camera "perspective" "float fov" [40]
    SurfaceIntegrator "directlighting"
    WorldBegin
    LightSource "distant" "point from" [0 0 -5] "point to" [0 0 0]
      "rgb L" [3.14159 3.14159 3.14159]
    Texture "pic" "color" "imagemap" "string filename" ["{tex_filename}"]
    Material "matte" "texture Kd" "pic"
    Shape "trianglemesh" "integer indices" [0 1 2 2 3 0]
      "point P" [-2 -2 0  2 -2 0  2 2 0  -2 2 0]
      "float uv" [0 0  1 0  1 1  0 1]
    WorldEnd
    """))
    t_api.pbrt_init({"quiet": True, "write": False, "device": "cpu", "tile_samples": 1024})
    try:
        t_parser.parse_file(str(scene))
        return np.asarray(t_api._state.output)
    finally:
        t_api._state.__init__()


@pytest.mark.parametrize("ext", ["tga", "png"])
def test_imagemap_file_roundtrip_port(tmp_path, ext):
    """A half-red / half-green texture file shades the plane red on one
    side and green on the other."""
    tex = np.zeros((8, 8, 3), np.float32)
    tex[:, :4, 0] = 1.0   # left half red
    tex[:, 4:, 1] = 1.0   # right half green
    fn = os.path.join(tmp_path, f"t.{ext}")
    write_image(fn, tex)
    assert read_image(fn).shape[-1] == 3
    img = _render_plane_with_texture(tmp_path, fn.replace("\\", "/"))
    assert np.all(np.isfinite(img))
    h, w, _ = img.shape
    left = img[h // 2, 4: w // 2 - 4]
    right = img[h // 2, w // 2 + 4: w - 4]
    assert float(left[:, 0].mean()) > 2.0 * float(left[:, 1].mean() + 1e-6)
    assert float(right[:, 1].mean()) > 2.0 * float(right[:, 0].mean() + 1e-6)


def test_imagemap_missing_file_white_fallback_port(tmp_path, capsys, monkeypatch):
    """A missing texture file warns and shades with a white texel
    (reference imagemap.cpp:78-80)."""
    monkeypatch.setattr(t_api, "pbrt_init", _loud(t_api.pbrt_init))
    img = _render_plane_with_texture(tmp_path, "/nonexistent/nope.tga")
    assert np.all(np.isfinite(img))
    assert 0.5 < float(img[16, 16].mean()) < 1.5
    assert "using white texel" in capsys.readouterr().err


def _loud(init):
    """pbrt_init that keeps warnings on."""
    def wrapped(options=None):
        init(dict(options or {}, quiet=False))
    return wrapped


def _stripe_tex(trilinear):
    """128x128 horizontal stripes: value depends only on t (8 periods)."""
    h = w = 128
    tgrid = (np.arange(h) + 0.5) / h
    stripes = (np.sin(2 * np.pi * 8 * tgrid) * 0.5 + 0.5).astype(np.float32)
    img = np.repeat(np.repeat(stripes[:, None], w, axis=1)[..., None], 3, axis=-1)
    tt.ImageMapTexture._cache[("__stripes__", 1.0)] = img
    return tt.ImageMapTexture(tt.UVMapping2D(), "__stripes__", spectral=False,
                              trilinear=trilinear)


def _footprint_sg(s, t, dx, dy):
    n = len(s)
    z3 = torch.zeros((n, 3))
    uv = torch.as_tensor(np.stack([s, t], -1).astype(np.float32))
    return tt.ShadingGeom(z3, uv, z3, z3, torch.as_tensor(np.tile(np.float32(dx), (n, 1))),
                          torch.as_tensor(np.tile(np.float32(dy), (n, 1))))


def test_ewa_beats_trilinear_on_anisotropic_footprints_port():
    """A footprint long along s on stripes varying in t: EWA keeps the
    stripe signal (level from the MINOR axis) while trilinear's
    max-width level washes it out toward the global mean."""
    rng = np.random.RandomState(1)
    s = rng.rand(64).astype(np.float32)
    t = rng.rand(64).astype(np.float32)
    sg = _footprint_sg(s, t, [[0.25, 0.0]], [[0.0, 1.0 / 256.0]])
    truth = np.sin(2 * np.pi * 8 * t) * 0.5 + 0.5
    err_ewa = float(np.abs(_stripe_tex(False).eval(sg).numpy() - truth).mean())
    err_tri = float(np.abs(_stripe_tex(True).eval(sg).numpy() - truth).mean())
    assert err_ewa < 0.5 * err_tri, (err_ewa, err_tri)
    assert err_ewa < 0.12, err_ewa


def test_ewa_isotropic_matches_trilinear_port():
    """With an isotropic footprint the two filters agree closely."""
    rng = np.random.RandomState(2)
    s = rng.rand(32).astype(np.float32)
    t = rng.rand(32).astype(np.float32)
    sg = _footprint_sg(s, t, [[1.0 / 128.0, 0.0]], [[0.0, 1.0 / 128.0]])
    np.testing.assert_allclose(_stripe_tex(False).eval(sg).numpy(),
                               _stripe_tex(True).eval(sg).numpy(), atol=0.06)


def test_trilinear_param_honored_port():
    assert _stripe_tex(trilinear=True).trilinear is True
    assert _stripe_tex(trilinear=False).trilinear is False
