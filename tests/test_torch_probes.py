"""The port's surfacepoints and createprobes renderers and the integrators
that read their output, useprobes and dipolesubsurface, against the JAX
package's.

Scene: tests/test_integrators.py's BASE / WORLD (a sphere on a disk,
16 x 16, 1 spp). Limits: surface points identical (host NumPy with the
same RNG stream); probe coefficients within 1e-4 relative to the
largest (path radiance along the same rays, summed over directions in
another order); point irradiance within 1e-5 of the largest; renders
within the whole-slice limits of tests/test_torch_slice.py.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.integrators import extra as j_extra
from pbrt_tpu.renderers.surfacepoints import generate_surface_points as j_points
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.integrators import extra as t_extra
from pbrt_tpu_torch.renderers import driver as t_driver
from pbrt_tpu_torch.renderers.surfacepoints import generate_surface_points as t_points
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from test_integrators import BASE, WORLD
from test_torch_extra_integrators import assert_same_image, render
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

MESH_SPHERE = ('AttributeBegin\nTranslate 1.5 0 1\nMaterial "matte" "rgb Kd" [.4 .5 .6]\n'
               'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
               '"point P" [-1 -1 0 1 -1 0 1 1 0 -1 1 0]\nAttributeEnd\n')


def _scene_pair(tmp_path, text):
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    return (j_compile(_parse(j_api, j_parser, path)),
            t_compile(_parse(t_api, t_parser, path), "cpu"))


def test_surface_points_identical_to_jax(tmp_path):
    """Triangles and spheres get points (the disk none: ROADMAP R21)."""
    js, ts = _scene_pair(tmp_path, BASE + WORLD.replace("WorldEnd", MESH_SPHERE + "WorldEnd"))
    for min_dist, seed in ((0.4, 0), (0.15, 3)):
        got = t_points(ts, min_dist, seed)
        ref = j_points(js, min_dist, seed)
        assert len(got[0]) > 50
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


def _renderer_text(tmp_path, renderer, fn):
    return BASE + f'Renderer "{renderer}" "string filename" ["{fn}"]' + {
        "surfacepoints": ' "float minsampledistance" [0.4]\n',
        "createprobes": ' "integer lmax" [2] "integer indirectsamples" [64]\n'}[renderer] + WORLD


def test_renderer_files_match_jax(tmp_path):
    """surfacepoints: the same npz keys and arrays; createprobes: the same
    keys, grid and header, coefficients within 1e-4 of the largest."""
    for renderer in ("surfacepoints", "createprobes"):
        outs = {}
        for tag, api, parser in (("t", t_api, t_parser), ("j", j_api, j_parser)):
            fn = tmp_path / f"{renderer}_{tag}.npz"
            path = tmp_path / "scene.pbrt"
            path.write_text(_renderer_text(tmp_path, renderer, fn))
            out = render(api, parser, path)
            assert out["file"] == str(fn)
            outs[tag] = dict(np.load(fn))
        got, ref = outs["t"], outs["j"]
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            if k == "coeffs":
                np.testing.assert_allclose(got[k], ref[k], rtol=0,
                                           atol=1e-4 * np.abs(ref[k]).max())
                assert np.abs(ref[k]).max() > 0
            else:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_useprobes_reads_either_package_file(tmp_path):
    """Probes made by each package; each package's useprobes renders from
    its own file and from the other's, all four within the render
    limits of the JAX package's render of its own file."""
    files = {}
    for tag, api, parser in (("t", t_api, t_parser), ("j", j_api, j_parser)):
        files[tag] = tmp_path / f"probes_{tag}.npz"
        path = tmp_path / "make.pbrt"
        path.write_text(_renderer_text(tmp_path, "createprobes", files[tag]))
        render(api, parser, path)
    images = {}
    for tag, api, parser in (("t", t_api, t_parser), ("j", j_api, j_parser)):
        for src in ("t", "j"):
            path = tmp_path / f"use_{tag}_{src}.pbrt"
            path.write_text(BASE + f'SurfaceIntegrator "useprobes" "string filename" '
                                   f'["{files[src]}"]\n' + WORLD)
            images[tag, src] = np.asarray(render(api, parser, path))
    for key, img in images.items():
        assert_same_image(img, images["j", "j"])


def test_useprobes_without_file_warns(tmp_path, capsys, monkeypatch):
    """A probe file that cannot be read warns and renders black, as in
    the JAX package."""
    from pbrt_tpu_torch.core import error

    monkeypatch.setattr(error, "quiet", False)
    path = tmp_path / "scene.pbrt"
    path.write_text(BASE + f'SurfaceIntegrator "useprobes" "string filename" '
                           f'["{tmp_path / "missing.npz"}"]\n' + WORLD)
    t_api.pbrt_init({"write": False, "device": "cpu", "tile_samples": 256})
    try:
        t_parser.parse_file(str(path))
        img = np.asarray(t_api._state.output)
    finally:
        t_api._state.__init__()
    assert "useprobes: cannot load" in capsys.readouterr().err
    assert img.shape == (16, 16, 3) and not img.any()


SSS = {
    "named": 'Material "subsurface" "string name" ["Marble"]',
    "explicit": 'Material "subsurface" "rgb sigma_a" [.02 .05 .1] '
                '"rgb sigma_prime_s" [1.5 2 2.5] "float scale" [2]',
}


@pytest.mark.parametrize("material", list(SSS))
def test_dipole_render_matches_jax(tmp_path, material):
    """A named and an explicit subsurface material: both packages take
    their coefficients from the scene's first subsurface record."""
    path = tmp_path / "scene.pbrt"
    path.write_text(BASE + 'SurfaceIntegrator "dipolesubsurface" "float minsampledistance" [0.4]\n'
                    'WorldBegin\nLightSource "point" "point from" [0 3 -2] "rgb I" [25 25 25]\n'
                    f'{SSS[material]}\nShape "sphere" "float radius" [0.8]\nWorldEnd\n')
    assert_same_image(render(t_api, t_parser, path), render(j_api, j_parser, path))


def test_dipole_on_identical_points_matches_jax(tmp_path):
    """The JAX package's surface points and their irradiance, carried
    across by bridge.py: the port's point irradiance, and its li_dipole
    on 256 camera rays aimed over the sphere, against the JAX package's
    (the port sums over the points in chunks of 7 here, the JAX package
    in one piece: the limits above)."""
    text = BASE + 'WorldBegin\nLightSource "point" "point from" [0 3 -2] "rgb I" [25 25 25]\n' + \
        SSS["named"] + '\nShape "sphere" "float radius" [0.8]\nWorldEnd\n'
    js, ts = _scene_pair(tmp_path, text)
    p, n, a = j_points(js, 0.3, 0)
    j_pts = j_extra.compute_point_irradiance(
        js, j_extra.SurfacePoints(p=p, n=n, area=a, E=np.zeros((len(p), 30), np.float32)), 0)
    arrays = bridge.tuple_to_arrays(j_pts, "pts")
    t_pts = bridge.surface_points_from_arrays(arrays, "cpu")
    got_e = t_extra.compute_point_irradiance(ts, t_pts._replace(E=torch.zeros_like(t_pts.E)), 0).E
    np.testing.assert_allclose(got_e.numpy(), arrays["pts.E"], rtol=0,
                               atol=1e-5 * arrays["pts.E"].max())
    assert (arrays["pts.E"].max(-1) > 0).mean() > 0.3

    rng = np.random.RandomState(1)
    N = 256
    o = np.tile([[0.0, 1.0, -3.0]], (N, 1)).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, N), rng.uniform(-0.5, 0.0, N), np.ones(N)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pix = np.arange(N, dtype=np.int32)
    sig = t_driver._dipole_sigma(ts)
    import jax.numpy as jnp

    ref = np.asarray(j_extra.li_dipole(
        js, j_pts, JRay(jnp.asarray(o), jnp.asarray(d), jnp.zeros(N), jnp.full((N,), 1e30),
                        jnp.zeros(N)), jnp.asarray(pix), jnp.zeros(N, jnp.int32),
        sigma_a=sig[0], sigma_ps=sig[1], scale=1.0))
    chunk = t_extra.DIPOLE_CHUNK_ELEMS
    try:
        t_extra.DIPOLE_CHUNK_ELEMS = N * 30 * 7
        got = t_extra.li_dipole(
            ts, t_pts, Ray(torch.as_tensor(o), torch.as_tensor(d), torch.zeros(N),
                           torch.full((N,), 1e30), torch.zeros(N)),
            torch.as_tensor(pix, dtype=torch.int64), torch.zeros(N, dtype=torch.int64),
            sigma_a=sig[0], sigma_ps=sig[1], scale=1.0).numpy()
    finally:
        t_extra.DIPOLE_CHUNK_ELEMS = chunk
    assert (ref.max(-1) > 0).mean() > 0.5
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


def test_useprobes_on_identical_grid_matches_jax(tmp_path):
    """The JAX package's probe grid (from its own probe file) carried
    across by bridge.py: li_useprobes on 256 camera rays, against the
    JAX package's on the same grid (the render limits above)."""
    import jax.numpy as jnp
    from pbrt_tpu.renderers.createprobes import load_probes as j_load

    fn = tmp_path / "probes.npz"
    path = tmp_path / "make.pbrt"
    path.write_text(_renderer_text(tmp_path, "createprobes", fn))
    render(j_api, j_parser, path)
    js, ts = _scene_pair(tmp_path, BASE + WORLD)
    j_grid = j_load(str(fn))
    t_grid = bridge.probe_grid_from_arrays(bridge.tuple_to_arrays(j_grid, "probes"), "cpu")
    assert t_grid.dims == j_grid.dims and t_grid.lmax == j_grid.lmax
    rng = np.random.RandomState(4)
    N = 256
    o = np.tile([[0.0, 1.0, -3.0]], (N, 1)).astype(np.float32)
    d = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.8, 0.1, N), np.ones(N)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ref = np.asarray(j_extra.li_useprobes(
        js, j_grid, JRay(jnp.asarray(o), jnp.asarray(d), jnp.zeros(N), jnp.full((N,), 1e30),
                         jnp.zeros(N)), jnp.arange(N), jnp.zeros(N, jnp.int32)))
    got = t_extra.li_useprobes(ts, t_grid, Ray(torch.as_tensor(o), torch.as_tensor(d),
                                               torch.zeros(N), torch.full((N,), 1e30),
                                               torch.zeros(N)),
                               torch.arange(N), torch.zeros(N, dtype=torch.int64)).numpy()
    assert_same_image(got[None], ref[None])
