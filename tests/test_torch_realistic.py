"""The port's realistic lens camera and autofocus
(pbrt_tpu_torch/cameras/realistic.py) against the JAX package's, and the
port's versions of tests/test_realistic_camera.py's lens checks.

Limits: the parsed lens rows exactly; ray origins, directions and
weights of identical film points and lens samples within 1e-5 (relative
plus absolute; float32 sqrt/division orders); rays that miss an
aperture (weight 0) identical. Autofocus on the textured plane at 500
units (one zone, 48 x 48, 2 spp, the same host jitter streams in both
packages): the film distance within 1e-4 of the JAX package's, relative.
"""
import types

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import realistic as j_real
from pbrt_tpu.core.transform import Transform as JTransform
from pbrt_tpu.renderers.driver import build_li_fn as j_build_li_fn
from pbrt_tpu.scene.paramset import ParamSet as JParamSet
from pbrt_tpu_torch.cameras import realistic as t_real
from pbrt_tpu_torch.core.transform import Transform as TTransform
from pbrt_tpu_torch.renderers.driver import build_li_fn as t_build_li_fn
from pbrt_tpu_torch.scene.paramset import ParamSet as TParamSet
from test_realistic_camera import BFD_THEORY, INV_F, LENS
from test_realistic_camera import _plane_scene as j_plane_scene

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def _params(ParamSet, film_dist, ap):
    p = ParamSet()
    p.add("string", "specfile", [LENS])
    p.add("float", "filmdistance", [film_dist])
    p.add("float", "aperture_diameter", [ap])
    p.add("float", "filmdiag", [40.0])
    return p


def t_camera(film_dist, res=64, ap=6.0, c2w=None):
    return t_real.make_realistic_camera(_params(TParamSet, film_dist, ap), c2w or TTransform(),
                                        res, res, 0.0, 1.0)


def j_camera(film_dist, res=64, ap=6.0, c2w=None):
    return j_real.make_realistic_camera(_params(JParamSet, film_dist, ap), c2w or JTransform(),
                                        res, res, 0.0, 1.0)


def test_parse_lens_file_matches_jax(tmp_path):
    """The fixture, and a lens with a stop row and a rear element of
    negative radius (its aperture_diameter overrides the stop's)."""
    lens = tmp_path / "stop.dat"
    lens.write_text("# front to back\n40 4 1.6 10\n0 3 0 5\n-30 2.5 1.5 9\n\n-60 0 1.0 9\n")
    for path in (LENS, str(lens)):
        for got, ref in zip(t_real.parse_lens_file(path, 3.5), j_real.parse_lens_file(path, 3.5)):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("film_dist,ap,rotated", [(BFD_THEORY, 6.0, False), (44.0, 2.0, True),
                                                  (60.0, 12.0, False)])
def test_generate_rays_match_jax(film_dist, ap, rotated):
    rng = np.random.RandomState(int(film_dist))
    n = 4096
    px, py, u1, u2, ut = (rng.rand(n).astype(np.float32) for _ in range(5))
    px, py = px * 64, py * 64
    t_c2w = j_c2w = None
    if rotated:
        t_c2w = TTransform.translate([0.5, 1.0, -2.0]) * TTransform.rotate(25.0, [0.2, 1.0, 0.1])
        j_c2w = JTransform.translate([0.5, 1.0, -2.0]) * JTransform.rotate(25.0, [0.2, 1.0, 0.1])
    t_ray, t_w = t_camera(film_dist, ap=ap, c2w=t_c2w).generate_rays(
        *(torch.as_tensor(x) for x in (px, py, u1, u2, ut)))
    j_ray, j_w = j_camera(film_dist, ap=ap, c2w=j_c2w).generate_rays(
        *(jnp.asarray(x) for x in (px, py, u1, u2, ut)))
    j_w = np.asarray(j_w)
    np.testing.assert_array_equal(t_w.numpy() > 0, j_w > 0)
    assert 0.05 < (j_w > 0).mean() < 1.0   # some rays pass, some miss an aperture
    np.testing.assert_allclose(t_w.numpy(), j_w, rtol=1e-5, atol=1e-7)
    ok = j_w > 0
    for f in ("o", "d", "time"):
        got, ref = getattr(t_ray, f).numpy(), np.asarray(getattr(j_ray, f))
        np.testing.assert_allclose(got[ok], ref[ok], rtol=1e-5, atol=1e-5, err_msg=f)
    assert torch.isinf(t_ray.tmax).all() and (t_ray.tmin == 0).all()


def _axis_rays(cam, n=256):
    """Rays from the central film point through n lens samples."""
    rng = np.random.RandomState(0)
    full = torch.full((n,), cam.width / 2.0)
    ray, w = cam.generate_rays(full, full, torch.as_tensor(rng.rand(n), dtype=torch.float32),
                               torch.as_tensor(rng.rand(n), dtype=torch.float32),
                               torch.zeros(n))
    return ray.d.numpy(), w.numpy()


def _collimation_error(film_dist):
    d, w = _axis_rays(t_camera(film_dist))
    ok = w > 0
    assert ok.sum() > 50, "lens passes too few rays"
    return float(np.sqrt((d[ok][:, :2] ** 2).sum(-1)).mean())


def test_back_focal_distance_matches_theory():
    """tests/test_realistic_camera.py:61 on the port: scanning the film
    distance, the on-axis exit beam is most nearly parallel at the
    thick-lens back focal distance."""
    cands = np.linspace(0.85 * BFD_THEORY, 1.15 * BFD_THEORY, 13)
    errs = [_collimation_error(float(fd)) for fd in cands]
    best = float(cands[int(np.argmin(errs))])
    assert abs(best - BFD_THEORY) / BFD_THEORY < 0.05, (best, BFD_THEORY, errs)
    assert max(errs) > 3.0 * min(errs), errs


def test_exit_rays_point_into_scene_with_weight():
    """tests/test_realistic_camera.py:74 on the port: passed rays leave
    the front element along +z with weight pi (A/2)^2 cos^4 / fd^2, A
    the rear element's aperture (8 mm)."""
    d, w = _axis_rays(t_camera(BFD_THEORY))
    ok = w > 0
    assert np.all(d[ok][:, 2] > 0.5)
    w_max = np.pi * 4.0 * 4.0 / (BFD_THEORY * BFD_THEORY)
    assert np.all(w[ok] <= w_max * 1.001)
    assert np.all(w[ok] > 0.5 * w_max)


def _t_plane_scene(dist):
    """tests/test_realistic_camera.py's plane scene through the port's
    scene API: a checkered quad at z = dist under a head-on distant light."""
    from pbrt_tpu_torch.scene import api
    from pbrt_tpu_torch.scene.compile import compile_scene

    api._state.__init__()
    api.pbrt_init({"quiet": True, "device": "cpu"})
    try:
        cam_p = TParamSet()
        cam_p.add("float", "fov", [40.0])
        api.pbrt_camera("perspective", cam_p)
        api.pbrt_world_begin()
        lp = TParamSet()
        lp.add("point", "from", [0.0, 0.0, -10.0])
        lp.add("point", "to", [0.0, 0.0, 0.0])
        lp.add("rgb", "L", [6.0, 6.0, 6.0])
        api.pbrt_light_source("distant", lp)
        tp = TParamSet()
        tp.add("float", "uscale", [24.0])
        tp.add("float", "vscale", [24.0])
        tp.add("rgb", "tex1", [0.9, 0.9, 0.9])
        tp.add("rgb", "tex2", [0.05, 0.05, 0.05])
        api.pbrt_texture("checks", "color", "checkerboard", tp)
        mp = TParamSet()
        mp.add("texture", "Kd", ["checks"])
        api.pbrt_material("matte", mp)
        sp = TParamSet()
        ext = dist * 0.8
        sp.add("integer", "indices", [0, 1, 2, 2, 3, 0])
        sp.add("point", "P", [-ext, -ext, dist, ext, -ext, dist, ext, ext, dist, -ext, ext, dist])
        sp.add("float", "uv", [0.0, 0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0])
        api.pbrt_shape("trianglemesh", sp)
        ro = api.get_state().render_options
        return compile_scene(ro, "cpu"), ro
    finally:
        api._state.__init__()


def test_autofocus_matches_jax():
    """Both packages autofocus the biconvex lens on the plane at 500
    units from a start 2% long of the thin-lens image distance (the
    sharpness peak lies inside both scans, so the log-parabola fit runs):
    one zone, 48 x 48, 2 spp. The JAX package's radiance function is
    jitted once here (each candidate then reuses it; its code is
    unchanged); the port batches the candidates' rays."""
    OBJ, res = 500.0, 48
    start = 1.02 / (INV_F - 1.0 / OBJ)
    film = types.SimpleNamespace(xres=res, yres=res)
    zone = [(0.3, 0.7, 0.3, 0.7)]
    j_scene, j_ro = j_plane_scene(OBJ)
    j_cam = j_camera(start, res=res)
    j_cam.lens.af_zones = list(zone)
    j_li = j_build_li_fn(j_scene, j_ro, {"quiet": True})
    j_real.autofocus(j_scene, j_cam, film, jax.jit(j_li, static_argnums=3), seed=0, spp=2)
    t_scene, t_ro = _t_plane_scene(OBJ)
    t_cam = t_camera(start, res=res)
    t_cam.lens.af_zones = list(zone)
    t_real.autofocus(t_scene, t_cam, film, t_build_li_fn(t_scene, t_ro, {}), seed=0, spp=2)
    got, ref = t_cam.lens.film_dist, j_cam.lens.film_dist
    assert got != start and abs(got - start) > 0.02 * start   # it moved
    assert abs(got - ref) <= 1e-4 * ref, (got, ref)
