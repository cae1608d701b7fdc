"""Scene-parameter gradients of the port (pbrt_tpu_torch/diff.py) against
central differences and against the JAX package's jax.grad.

The scene is tests/test_grad.py's (a point light above a scattering
homogeneous cube over a matte floor), built by each package from the
same api calls. The estimators are that file's four: d/d(sigma_a scale)
of a single-scatter march, d/d(albedo scale) of a 2-bounce path trace,
d/d(light power) through the photon splat, and d/d(sigma_s scale)
through the photonvolume march. Limits:

- against central differences of the same estimator (fixed counters, so
  both sides follow the same discrete events): test_grad.py's h and rtol;
- against jax.grad at s = 1, on identical rays and, for the photon
  estimators, over one frozen shoot (the JAX package's, carried across
  by bridge.frozen_shoot_from_arrays): gradients within rtol 1e-3,
  losses within rtol 1e-4;
- the port's own freeze_photon_shoot: per-class indices, sort orders,
  cell offsets and occupancies equal to the JAX package's (same
  counter-based sampler); positions, directions and grid extents within
  1e-5 (the packages round a few operations apart).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from pbrt_tpu import diff as j_diff
from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.integrators import photonvolume as j_pv
from pbrt_tpu.integrators import surface as j_surf
from pbrt_tpu.integrators import volume as j_vol
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu.scene.paramset import ParamSet as JParamSet
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch import diff as t_diff
from pbrt_tpu_torch.integrators import photonvolume as t_pv
from pbrt_tpu_torch.integrators import surface as t_surf
from pbrt_tpu_torch.photon import map as t_map

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

S = 30
FREEZE, Q_PTS, FD = chip_smoke.GRAD_FREEZE, chip_smoke.GRAD_Q_PTS, chip_smoke.GRAD_FD
ray_arrays = chip_smoke.grad_ray_arrays


def port_scene(**kw):
    return chip_smoke.grad_port_scene("cpu", **kw)


def jax_scene(**kw):
    return chip_smoke.grad_scene(j_api, JParamSet, j_compile, **kw)


def port_rays(o, d):
    return chip_smoke.grad_port_rays(o, d, "cpu")


def jax_rays(o, d):
    n = len(o)
    return (JRay(jnp.asarray(o), jnp.asarray(d), jnp.zeros(n), jnp.full((n,), jnp.inf),
                 jnp.zeros(n)),
            jnp.arange(n, dtype=jnp.int32), jnp.zeros(n, jnp.int32))


def jax_losses(scene, frozen):
    """name -> loss(s) of the JAX package (test_grad.py's estimators)."""
    base_sa = jnp.asarray(scene.volume.sigma_a)
    base_ss = jnp.asarray(scene.volume.sigma_s)
    M = len(scene.materials)

    def march(s):
        ray, pixel, sidx = jax_rays(*ray_arrays(6))
        sc = j_diff.apply_params(scene, j_diff.DiffParams(sigma_a=base_sa * s))
        vr = j_vol.li_single(sc, ray, jnp.full((pixel.shape[0],), jnp.inf), pixel, sidx,
                             n_steps=8, seed=0)
        return jnp.mean(vr.L) + jnp.mean(vr.Tr)

    def path(s):
        ray, pixel, sidx = jax_rays(*ray_arrays(6, y=-0.2))
        sc = j_diff.apply_params(scene, j_diff.DiffParams(
            kd_scale=jnp.full((M, S), 1.0, jnp.float32) * s))
        return jnp.mean(j_surf.li_path(sc, ray, pixel, sidx, max_depth=2, seed=0))

    def splat(s):
        sc = j_diff.apply_params(scene, j_diff.DiffParams(
            light_scale=jnp.ones((scene.n_lights,)) * s))
        ctx = j_diff.diff_photon_ctx(sc, frozen)
        w = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (4, 1))
        flux, _ = j_pv.lphoton_volume(ctx.volume, jnp.asarray(Q_PTS), w,
                                      jnp.zeros((4,), jnp.float32), ctx.vol_n_used,
                                      ctx.vol_max_dist2)
        return jnp.mean(flux)

    def photonvolume(s):
        ray, pixel, sidx = jax_rays(*ray_arrays(4))
        sc = j_diff.apply_params(scene, j_diff.DiffParams(sigma_s=base_ss * s))
        ctx = j_diff.diff_photon_ctx(sc, frozen)
        vr = j_pv.li_photonvolume(sc, ctx, ray, jnp.full((pixel.shape[0],), jnp.inf), pixel,
                                  sidx, n_steps=8, seed=0)
        return jnp.mean(vr.L) + 0.1 * jnp.mean(vr.Tr)

    return {"march": march, "path": path, "splat": splat, "photonvolume": photonvolume}


@pytest.fixture(scope="module")
def port_setup():
    """The port's scene (sigma_s 0.9, as test_grad.py's photon fixture)
    and the port's own frozen shoot; and the path / march scene (0.6)."""
    scene = port_scene(sigma_s=0.9)
    frozen = t_diff.freeze_photon_shoot(scene, **FREEZE)
    assert frozen.classes.get(4) is not None, "no volume photons frozen"
    return {"photon": (scene, frozen), "plain": (port_scene(), None)}


@pytest.fixture(scope="module")
def jax_setup():
    scene = jax_scene(sigma_s=0.9)
    frozen = j_diff.freeze_photon_shoot(scene, **FREEZE)
    return {"photon": (scene, frozen), "plain": (jax_scene(), None)}


@pytest.mark.parametrize("name", list(FD))
def test_port_grad_matches_central_differences(port_setup, name):
    which, h, rtol = FD[name]
    scene, frozen = port_setup[which]
    loss_fn = chip_smoke.grad_port_losses(scene, frozen)[name]
    g_ad, loss1 = chip_smoke.port_grad(loss_fn, "cpu")
    g_fd = chip_smoke.port_fd(loss_fn, "cpu", h)
    assert np.isfinite(g_ad) and np.isfinite(g_fd)
    assert abs(g_ad) > 0.0, "autograd gradient is exactly zero: graph severed"
    np.testing.assert_allclose(g_ad, g_fd, rtol=rtol, atol=1e-6)
    if name == "splat":
        # photon power is linear in light power: loss(s) = s * loss(1)
        np.testing.assert_allclose(g_ad, loss1, rtol=1e-4)


@pytest.mark.parametrize("name", list(FD))
def test_port_grad_matches_jax(port_setup, jax_setup, name):
    """The port's gradient and loss at s = 1 against jax.grad's, the
    photon estimators over the JAX package's frozen shoot carried
    across."""
    which = FD[name][0]
    j_scene, j_frozen = jax_setup[which]
    t_scene = port_setup[which][0]
    t_frozen = (None if j_frozen is None else
                bridge.frozen_shoot_from_arrays(bridge.frozen_shoot_to_arrays(j_frozen)))
    j_loss = jax_losses(j_scene, j_frozen)[name]
    j_l, j_g = jax.jit(jax.value_and_grad(j_loss))(jnp.float32(1.0))
    t_g, t_l = chip_smoke.port_grad(chip_smoke.grad_port_losses(t_scene, t_frozen)[name], "cpu")
    np.testing.assert_allclose(t_l, float(j_l), rtol=1e-4)
    np.testing.assert_allclose(t_g, float(j_g), rtol=1e-3)


def test_freeze_photon_shoot_matches_jax(port_setup, jax_setup):
    """Same counter-based sampler: the same deposits in each class, the
    same sorted-grid structures, the same majorant and settings."""
    t_fr = port_setup["photon"][1]
    j_fr = jax_setup["photon"][1]
    for f in ("n_batches", "B", "seed", "max_depth", "has_volume"):
        assert getattr(t_fr, f) == getattr(j_fr, f), f
    np.testing.assert_allclose(t_fr.majorant, j_fr.majorant, rtol=1e-6)
    assert t_fr.cfg == pytest.approx(j_fr.cfg)
    assert set(t_fr.classes) == set(j_fr.classes)
    for code, j_entry in j_fr.classes.items():
        t_entry = t_fr.classes[code]
        assert (t_entry is None) == (j_entry is None), code
        if j_entry is None:
            continue
        np.testing.assert_array_equal(t_entry[0], j_entry[0])
        np.testing.assert_allclose(t_entry[1], j_entry[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_entry[2], j_entry[2], rtol=1e-5, atol=1e-5)
        assert t_entry[4] == j_entry[4]
        t_st, j_st = t_entry[3], j_entry[3]
        assert t_st.dims == j_st.dims
        for f in ("order", "cell_start", "occ"):
            np.testing.assert_array_equal(getattr(t_st, f), getattr(j_st, f), err_msg=f)
        np.testing.assert_allclose(t_st.lo, j_st.lo, rtol=1e-6)
        # the grid's extent, dims / inv_cell, follows the positions: a
        # flat class (the floor's photons, ~2e-4 thick) turns their
        # ulp-level differences into a 1e-3 relative change of inv_cell
        np.testing.assert_allclose(np.asarray(t_st.dims) / t_st.inv_cell,
                                   np.asarray(j_st.dims) / j_st.inv_cell, rtol=1e-6, atol=1e-5)


def test_default_params_and_bridge(port_setup, jax_setup):
    """default_params has the JAX package's shapes and values, copies
    the scene's tensors, and diff_params_from_arrays carries it across."""
    t_scene = port_setup["photon"][0]
    j_scene = jax_setup["photon"][0]
    t_p = t_diff.default_params(t_scene)
    j_p = j_diff.default_params(j_scene)
    arrays = {f"params.{f}": np.asarray(v) for f, v in j_p._asdict().items() if v is not None}
    carried = bridge.diff_params_from_arrays(arrays, "cpu")
    for f in t_diff.DiffParams._fields:
        jv = getattr(j_p, f)
        assert (getattr(t_p, f) is None) == (jv is None), f
        if jv is None:
            continue
        np.testing.assert_allclose(getattr(t_p, f).numpy(), np.asarray(jv), rtol=1e-6)
        np.testing.assert_allclose(getattr(carried, f).numpy(), np.asarray(jv), rtol=0)
    assert t_p.sigma_a.data_ptr() != t_scene.volume.sigma_a.data_ptr()
    assert tuple(t_p.kd_scale.shape) == (len(t_scene.materials), S)
    assert tuple(t_p.light_scale.shape) == (t_scene.n_lights,)


def test_unscaled_albedo_is_bit_identical(port_setup):
    """kd_scale = None renders as before, and a scale of ones gives the
    same bits (x * 1.0 is exact)."""
    scene = port_setup["plain"][0]
    assert scene.kd_scale is None
    ray, pixel, sidx = port_rays(*ray_arrays(6, y=-0.2))
    base = t_surf.li_path(scene, ray, pixel, sidx, max_depth=3, seed=0)
    ones = t_diff.apply_params(scene, t_diff.default_params(scene, want=("kd_scale",)))
    scaled = t_surf.li_path(ones, ray, pixel, sidx, max_depth=3, seed=0)
    assert scene.kd_scale is None
    assert torch.equal(base, scaled)
    assert float(base.sum()) > 0.0


def test_miss_lanes_give_finite_gradients(port_setup):
    """Half of the rays leave the scene at once: their frames, lobes and
    volume spans are degenerate, and no NaN may reach the gradient."""
    scene, frozen = port_setup["photon"]
    ray, pixel, sidx = port_rays(*ray_arrays(6, y=-0.2, miss_half=True))
    params = t_diff.default_params(scene)
    leaves = [params.sigma_a, params.sigma_s, params.light_scale, params.kd_scale]
    for t in leaves:
        t.requires_grad_(True)
    sc = t_diff.apply_params(scene, params)
    L = t_surf.li_path(sc, ray, pixel, sidx, max_depth=3, seed=0)
    vr = t_pv.li_photonvolume(sc, t_diff.diff_photon_ctx(sc, frozen), ray,
                              torch.full((len(pixel),), float("inf")), pixel, sidx,
                              n_steps=4, seed=0)
    assert torch.all(L[1::2] == 0.0), "the miss lanes must see nothing"
    grads = torch.autograd.grad(torch.mean(L) + torch.mean(vr.L) + torch.mean(vr.Tr), leaves)
    for name, g in zip(("sigma_a", "sigma_s", "light_scale", "kd_scale"), grads):
        assert torch.all(torch.isfinite(g)), name
        assert float(torch.abs(g).sum()) > 0.0, name


def test_photon_map_from_structure_keeps_the_graph():
    """build_photon_map_from over a fixed structure carries the powers'
    graph through the sort, and the kNN estimate differentiates back to
    each photon's power."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    wi = rng.normal(size=(400, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    alpha = torch.as_tensor(rng.uniform(0, 1, (400, S)).astype(np.float32)).requires_grad_(True)
    st = t_map.photon_map_structure(pos, 0.3, target_k=10)
    pm = t_map.build_photon_map_from(st, pos, alpha * 2.0, wi, "cpu")
    assert pm.alpha.requires_grad
    q = torch.as_tensor(rng.uniform(-0.8, 0.8, (32, 3)).astype(np.float32))
    res = t_map.knn_weighted_flux(pm, q, 10, 0.25,
                                  lambda wx, wy, wz, d2, v, r2: torch.ones_like(d2))
    (g,) = torch.autograd.grad(res.flux.sum(), alpha)
    # each photon's gradient is 2 x (times it was among a query's k
    # nearest) in every bin, with the truncation weight
    assert torch.all(torch.isfinite(g)) and float(g.sum()) > 0.0
    assert torch.all(g == g[:, :1])


@pytest.mark.parametrize("route", ["k1", "k2"])
def test_render_gradient_through_the_kernels_twins(tmp_path, route):
    """chip_smoke.py [30b]'s gradient of a render on the CPU: the small
    scene (flat t-pass, K1's plain twin) and, with one more sphere past
    the wide threshold, the wide pipeline (K2's plain twin) run under
    autograd, tile by tile; finite, and along the matte materials'
    albedo with Russian roulette off equal to central differences (no
    discrete choice moves with a matte albedo)."""
    text = chip_smoke.small_scene_text(8, 1)
    if route == "k2":
        P, idx = chip_smoke.uv_sphere(24, 24, 0.3, (0.0, 1.5, -1.0))
        text = text.replace("WorldEnd\n", 'Material "matte" "rgb Kd" [.3 .6 .3]\n'
                            + chip_smoke.mesh(P, idx) + "WorldEnd\n")
    scene, ro = chip_smoke.compile_text(text, "grad_" + route, str(tmp_path),
                                        torch.device("cpu"))
    assert (scene.accel.wide is not None) == (route == "k2")
    assert (scene.accel.tri_soa is not None) == (route == "k1")
    ones = torch.ones((len(scene.materials), S))
    depth, h = 3, 1e-2
    loss, g = chip_smoke.grad_render(scene, ro, ones, depth, tile_rays=16)
    assert loss > 0.0 and bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0
    v = torch.tensor([[1.0 if m.kind == "matte" else 0.0] for m in scene.materials]).expand_as(ones)
    _, g0 = chip_smoke.grad_render(scene, ro, ones, depth, tile_rays=16, rr_start=depth)
    lp, lm = (chip_smoke.grad_render(scene, ro, ones + sh * v, depth, tile_rays=16,
                                     rr_start=depth, want_grad=False)[0] for sh in (h, -h))
    np.testing.assert_allclose(float((g0 * v).sum()), (lp - lm) / (2 * h), rtol=2e-2)
