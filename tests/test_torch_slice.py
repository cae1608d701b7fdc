"""The port's main path against the JAX package, end to end.

One small scene (tessellated spheres in matte, plastic, mirror and
dispersive glass, a triangle area light, a point light, a ground
plane: 292 triangles) goes through both front ends and both renderers
at the same seed. Hand-over between the packages is by NumPy arrays.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.accel.bvh import build_bvh as j_build_bvh
from pbrt_tpu.accel.wide_bvh import build_wide_bvh as j_build_wide_bvh
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.accel.bvh import build_bvh
from pbrt_tpu_torch.accel.wide_bvh import build_wide_bvh
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def uv_sphere(n, radius, center):
    th = np.linspace(0.0, np.pi, n + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    P = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1)
    P = P.reshape(-1, 3) * radius + np.asarray(center)
    idx = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            idx += [(a, a + n + 1, a + 1), (a + 1, a + n + 1, a + n + 2)]
    return P.astype(np.float32), np.asarray(idx, np.int32).reshape(-1)


def mesh(P, idx):
    return ('Shape "trianglemesh" "integer indices" [' + " ".join(map(str, idx.tolist()))
            + '] "point P" [' + " ".join(f"{v:.6f}" for v in np.ravel(P)) + "]\n")


QUAD = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]], np.float32)
QUAD_IDX = np.array([0, 2, 1, 0, 3, 2])


def scene_text(res=32, spp=4, depth=3, sampler="lowdiscrepancy", pixel_filter="box"):
    s = (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
         f'Sampler "{sampler}" "integer pixelsamples" [{spp}]\n'
         f'PixelFilter "{pixel_filter}"\n'
         'LookAt 0 1.5 -5  0 0.3 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
         f'SurfaceIntegrator "path" "integer maxdepth" [{depth}]\nWorldBegin\n'
         'LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]\n'
         'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [6 6 6]\n'
         + mesh(QUAD + [0, 3, 0], QUAD_IDX) + 'AttributeEnd\n')
    mats = ['Material "matte" "rgb Kd" [.6 .3 .2]',
            'Material "plastic" "rgb Kd" [.2 .3 .6] "rgb Ks" [.4 .4 .4] "float roughness" [.05]',
            'Material "mirror" "rgb Kr" [.9 .9 .9]',
            'Material "glass" "float index" [1.52] "float Vn" [36.4]']
    for k, m in enumerate(mats):
        P, idx = uv_sphere(6, 0.5, (-1.8 + 1.2 * k, 0.5, 0.0))
        s += f"AttributeBegin\n{m}\n" + mesh(P, idx) + "AttributeEnd\n"
    s += 'Material "matte" "rgb Kd" [.5 .5 .5]\n' + mesh(QUAD * 6, QUAD_IDX)
    return s + "WorldEnd\n"


class _Capture:
    """Forwards to an api module; WorldEnd keeps the render options and
    does not render."""

    def __init__(self, mod):
        self.mod = mod
        self.ro = None

    def __getattr__(self, name):
        return getattr(self.mod, name)

    def pbrt_world_end(self):
        self.ro = self.mod.get_state().render_options
        self.mod.pbrt_world_end(render=False)


def _parse(api, parser, path):
    api.pbrt_init({"quiet": True})
    cap = _Capture(api)
    try:
        parser.parse_file(str(path), api=cap)
    finally:
        api._state.__init__()
    return cap.ro


def _jax_arrays(js, wide):
    out = {f"geom.{f}": np.asarray(getattr(js.geom, f)) for f in bridge.GEOM_FIELDS}
    out.update({f"lights.{f}": np.asarray(getattr(js.lights, f)) for f in bridge.LIGHT_FIELDS})
    out.update({f"light_dist.{f}": np.asarray(getattr(js.light_dist, f))
                for f in bridge.DIST_FIELDS})
    out.update({f"wide.{f}": np.asarray(getattr(wide, f)) for f in bridge.WIDE_FIELDS})
    out["wide.n_blocks"] = np.asarray(wide.n_blocks)
    return out


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    path = tmp_path_factory.mktemp("scene") / "scene.pbrt"
    path.write_text(scene_text())
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    j_wide = j_build_wide_bvh(j_build_bvh(js.geom, "sah"), js.geom)
    tris = [x.numpy() for x in (ts.geom.tri_v0, ts.geom.tri_e1, ts.geom.tri_e2)]
    t_wide = build_wide_bvh(build_bvh(*tris, "sah"), *tris, "cpu")
    return _jax_arrays(js, j_wide), ts, t_wide


def test_compile_parity_through_bridge(compiled):
    """The port's compile equals the JAX compile array for array. Every
    array is host-built from the same NumPy math and must be identical,
    except the light-pick CDF: a float32 cumsum whose summation order
    differs between XLA and ATen (rtol 1e-6, a few ulp)."""
    ref, ts, t_wide = compiled
    got = bridge.scene_to_arrays(ts)
    got.update(bridge.to_arrays("wide", t_wide))
    assert ts.geom.n_tris == 292
    assert set(got) == set(ref)
    for key in sorted(ref):
        if key.startswith("light_dist."):
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got[key], ref[key].astype(got[key].dtype),
                                          err_msg=key)


def test_bridge_round_trip(compiled):
    """JAX arrays -> port tensors -> arrays is the identity."""
    ref, _, _ = compiled
    for part in bridge.PARTS:
        obj = bridge.from_arrays(ref, part, "cpu")
        for key, val in bridge.to_arrays(part, obj).items():
            np.testing.assert_array_equal(val, ref[key].astype(val.dtype), err_msg=key)


FORMERLY_NOT_PORTED = {
    "heightfield": 'Shape "heightfield" "integer nu" [3] "integer nv" [3] '
                   '"float Pz" [0 .2 0 .1 .3 .1 0 .2 0]',
    "nurbs": 'Shape "nurbs" "integer nu" [2] "integer nv" [2] "integer uorder" [2] '
             '"integer vorder" [2] "float uknots" [0 0 1 1] "float vknots" [0 0 1 1] '
             '"point P" [-1 0.5 -1 1 0.5 -1 -1 0.5 1 1 0.5 1]',
    "loopsubdiv": 'Shape "loopsubdiv" "integer nlevels" [2] "integer indices" [0 1 2 0 2 3] '
                  '"point P" [-1 .5 -1 1 .5 -1 1 .5 1 -1 .5 1]',
}
FORMERLY_NOT_PORTED_OPTIONS = {
    "realistic camera": 'Camera "realistic" "string specfile" "{lens}" '
                        '"float filmdistance" [52] "float aperture_diameter" [6] '
                        '"float filmdiag" [40]',
    "irradiancecache": 'SurfaceIntegrator "irradiancecache" "integer nsamples" [512]',
    "dipolesubsurface": 'SurfaceIntegrator "dipolesubsurface" "float minsampledistance" [0.5]',
    "igi": 'SurfaceIntegrator "igi" "integer nlights" [8] "integer nsets" [2] '
           '"integer maxdepth" [2]',
    "grid accelerator": 'Accelerator "grid"',
    "kdtree accelerator": 'Accelerator "kdtree"',
    "metropolis": 'Renderer "metropolis" "integer samplesperpixel" [64] '
                  '"integer bootstrapsamples" [4096]',
    "aggregatetest": 'Renderer "aggregatetest" "integer niters" [4096]',
}


def _feature_scene(tmp_path, opts, world, res=4):
    if "SurfaceIntegrator" not in opts:   # a short compile for the JAX package
        opts += '\nSurfaceIntegrator "directlighting" "integer maxdepth" [1]'
    path = tmp_path / "scene.pbrt"
    path.write_text(f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
                    'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
                    'LookAt 0 3 -3  0 0 0  0 1 0\nCamera "perspective" "float fov" [60]\n'
                    + opts + "\nWorldBegin\n"
                    'LightSource "point" "point from" [1 4 -2] "rgb I" [20 20 20]\n'
                    + world + "\n" + mesh(QUAD * 3, QUAD_IDX) + "WorldEnd\n")
    return path


@pytest.mark.parametrize("what", list(FORMERLY_NOT_PORTED) + list(FORMERLY_NOT_PORTED_OPTIONS))
def test_formerly_unported_features_render(tmp_path, what):
    """The shapes, camera, integrators, renderers and accelerators an
    earlier port refused render a finite 8 x 8 image equal to the JAX
    package's (the whole-slice limits below); aggregatetest reports the
    JAX package's mismatch count (0: this scene gets no binary tree)."""
    from test_realistic_camera import LENS

    opts = FORMERLY_NOT_PORTED_OPTIONS.get(what, "").replace("{lens}", LENS)
    world = FORMERLY_NOT_PORTED.get(what, "")
    if what == "dipolesubsurface":
        world = 'Material "subsurface" "string name" ["Marble"]\n' + world
    path = _feature_scene(tmp_path, opts, world, res=8)
    tile = {"tile_samples": 64}   # one tile of exactly the image's samples in both packages
    ref = _render(j_api, j_parser, path, tile)
    got = _render(t_api, t_parser, path, tile)
    if what == "aggregatetest":
        assert int(got) == int(ref) == 0
        return
    assert got.shape == ref.shape == (8, 8, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


def test_unknown_integrators_warn_and_fall_back(tmp_path, capsys, monkeypatch):
    """Integrator names neither package knows warn and render as the
    JAX package does: "path" for the surface, "single" for a volume. An
    unknown BVH split method warns and builds the SAH tree, as the JAX
    package's builders do."""
    from pbrt_tpu_torch.core import error

    monkeypatch.setattr(error, "quiet", False)
    rng = np.random.RandomState(3)
    v0, e1, e2 = (rng.normal(size=(300, 3)).astype(np.float32) for _ in range(3))
    sah = build_bvh(v0, e1, e2, "sah")
    capsys.readouterr()
    fallback = build_bvh(v0, e1, e2, "nonesuch")
    assert 'split method "nonesuch" unknown' in capsys.readouterr().err
    for got, ref in zip(fallback, sah):
        np.testing.assert_array_equal(got, ref)
    volume = ('Volume "homogeneous" "point p0" [-2 -1 -2] "point p1" [2 2 2] '
              '"rgb sigma_a" [.1 .1 .1] "rgb sigma_s" [.2 .2 .2]\n')
    images = {}
    for surf, vol in (("path", "single"), ("nonesuch", "single"), ("path", "nonesuch")):
        text = scene_text(res=8, spp=1, depth=2).replace('"path"', f'"{surf}"', 1)
        text = text.replace("WorldBegin\n", f'VolumeIntegrator "{vol}"\nWorldBegin\n' + volume)
        path = tmp_path / f"{surf}_{vol}.pbrt"
        path.write_text(text)
        t_api.pbrt_init({"write": False, "device": "cpu", "tile_samples": 64})
        try:
            t_parser.parse_file(str(path))
            images[surf, vol] = np.asarray(t_api._state.output)
        finally:
            t_api._state.__init__()
        err = capsys.readouterr().err
        assert ("nonesuch" in err) == ("nonesuch" in (surf, vol))
    assert images["path", "single"].mean() > 0
    for key in (("nonesuch", "single"), ("path", "nonesuch")):
        np.testing.assert_array_equal(images[key], images["path", "single"])


def _render(api, parser, path, options=None):
    api.pbrt_init({"quiet": True, "write": False, "device": "cpu", "tile_samples": 4096,
                   **(options or {})})
    try:
        parser.parse_file(str(path))
        return np.asarray(api._state.output)
    finally:
        api._state.__init__()


def test_named_constant_textures_match_inline_values(tmp_path):
    """Named "constant" textures (color and float) render exactly as the
    same values written inline on the material."""
    named = ('Texture "kd" "color" "constant" "rgb value" [.6 .3 .2]\n'
             'Texture "r" "float" "constant" "float value" [.05]\n'
             'Material "plastic" "texture Kd" "kd" "texture roughness" "r"\n')
    inline = 'Material "plastic" "rgb Kd" [.6 .3 .2] "float roughness" [.05]\n'
    images = []
    for k, material in enumerate((named, inline)):
        path = tmp_path / f"scene{k}.pbrt"
        path.write_text('Film "image" "integer xresolution" [8] "integer yresolution" [8]\n'
                        'Sampler "random" "integer pixelsamples" [1]\n'
                        'LookAt 0 3 -3  0 0 0  0 1 0\nCamera "perspective" "float fov" [60]\n'
                        'SurfaceIntegrator "path" "integer maxdepth" [2]\nWorldBegin\n'
                        'LightSource "point" "point from" [0 3 0] "rgb I" [10 10 10]\n'
                        + material + mesh(QUAD * 4, QUAD_IDX) + "WorldEnd\n")
        images.append(_render(t_api, t_parser, path))
    assert images[0].mean() > 0
    np.testing.assert_array_equal(images[0], images[1])


@pytest.mark.parametrize("sampler,pixel_filter", [("lowdiscrepancy", "box"),
                                                  ("stratified", "mitchell")])
def test_whole_slice_matches_jax_render(tmp_path, sampler, pixel_filter):
    """32x32, 4 spp, maxdepth 3, same seed. The random streams are
    bit-identical, so the images differ only by float rounding (XLA vs
    ATen transcendentals, sum orders, FMA contraction). Limits: image
    mean within 0.5%, and 99% of pixels within 1e-3 relative; a pixel
    can exceed it only when a rounding difference flips a discrete
    decision (silhouette hit, lobe pick, roulette) for one of its
    samples. Observed on this CPU: mean identical to 7 digits, 100% of
    pixels within 1e-3, worst pixel 2e-4 relative."""
    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(sampler=sampler, pixel_filter=pixel_filter))
    ref = _render(j_api, j_parser, path)
    got = _render(t_api, t_parser, path)
    assert got.shape == ref.shape == (32, 32, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


def test_cli_refuses_without_card(tmp_path, monkeypatch, capsys):
    """The CLI renders on CUDA by default and fails when there is no card."""
    from pbrt_tpu_torch import main as t_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(res=4, spp=1))
    assert t_main.main([str(path)]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_renders_on_cpu(tmp_path):
    from pbrt_tpu_torch import main as t_main
    from pbrt_tpu_torch.io.image import read_image

    path = tmp_path / "scene.pbrt"
    path.write_text(scene_text(res=8, spp=1, depth=2))
    out = tmp_path / "out.pfm"
    assert t_main.main(["--device", "cpu", "--quiet", "--tile-samples", "64",
                        "--outfile", str(out), str(path)]) == 0
    img = read_image(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0


def test_cli_fails_on_a_scene_left_in_its_world_block(tmp_path, capsys):
    """As the JAX CLI, which closes with pbrtCleanup: a scene with
    WorldBegin but no WorldEnd exits 1 with the reference's message and
    writes no image; the complete scene still exits 0 with its image."""
    from pbrt_tpu.core.error import PbrtError as JPbrtError
    from pbrt_tpu import main as j_main
    from pbrt_tpu_torch import main as t_main

    text = scene_text(res=8, spp=1, depth=1)
    path = tmp_path / "unfinished.pbrt"
    path.write_text(text.replace("WorldEnd\n", ""))
    out = tmp_path / "out.pfm"
    msg = "pbrtCleanup() called while inside world block."
    try:
        with pytest.raises(JPbrtError, match=msg.replace("(", r"\(").replace(")", r"\)")):
            j_main.main(["--quiet", "--outfile", str(tmp_path / "j.pfm"), str(path)])
    finally:
        j_api._state.__init__()   # the JAX CLI leaves its api state in the world block
    capsys.readouterr()
    assert t_main.main(["--device", "cpu", "--quiet", "--outfile", str(out), str(path)]) == 1
    assert capsys.readouterr().err.strip() == f"pbrt_tpu_torch: {msg}"
    assert not out.exists()
    path.write_text(text)
    assert t_main.main(["--device", "cpu", "--quiet", "--tile-samples", "64",
                        "--outfile", str(out), str(path)]) == 0
    assert out.exists()
    # the state is reset after the failure too: a second scene renders in this process
    assert t_main.main(["--device", "cpu", "--quiet", "--tile-samples", "64",
                        "--outfile", str(out), str(path)]) == 0
