"""The port's photon integrators against the JAX package's, on maps the
JAX package built and bridge.py carried across.

The scene is tests/test_torch_photon_shooter.py's PHOTON_SCENE. The maps
are built by the JAX package's map builders from photons made with NumPy
from a seed (powers on the floor and the wall, incoming from above; a
volume map over the medium; a radiance map with normals), so no JAX
shooting is compiled here; `photon_ctx_from_arrays` turns them into the
port's. 256 rays from the camera, aimed with a seed over the spot's
caustic, the floor, the wall, the glass sphere and the rainbow region,
go through li_photonmap with final gather (8 gather samples; maxdepth 1,
to keep the JAX package's eager gather loop to one compile) and without
(maxdepth 3: through the glass sphere), and through li_photonvolume (12
march steps), at the same counters.

Limits (the render limits of tests/test_torch_slice.py): the mean within
0.5% and at least 99% of rays within 1e-3 relative.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from pbrt_tpu.core.geometry import Ray as JRay
from pbrt_tpu.integrators import photonmap as j_pm
from pbrt_tpu.integrators import photonvolume as j_pv
from pbrt_tpu.photon import map as j_map
from pbrt_tpu.photon.shooter import PhotonCtx as JCtx
from pbrt_tpu.renderers import driver as j_driver
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.integrators import photonmap as t_pm
from pbrt_tpu_torch.integrators import photonvolume as t_pv
from pbrt_tpu_torch.renderers import driver as t_driver
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from test_torch_photon_shooter import PHOTON_SCENE
from test_torch_quadrics import assert_compile_parity
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

N = 256


def surface_photons(rng, n):
    """Photons on the floor (y = -0.5) and the wall (z = 2), arriving
    from the lit side, denser under the spot."""
    floor = np.stack([rng.uniform(-3, 3, n), np.full(n, -0.5), rng.uniform(-3, 2, n)], -1)
    floor[: n // 3, [0, 2]] = rng.normal([0.4, 0.0], 0.3, (n // 3, 2))
    wall = np.stack([rng.uniform(-3, 3, n // 2), rng.uniform(-0.5, 3, n // 2),
                     np.full(n // 2, 2.0)], -1)
    pos = np.concatenate([floor, wall])
    wi = rng.normal(size=pos.shape)
    wi[:n, 1] = np.abs(wi[:n, 1])
    wi[n:, 2] = -np.abs(wi[n:, 2])
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    alpha = rng.uniform(0.5, 1.5, (len(pos), 30)) * 1e-3
    return pos.astype(np.float32), alpha.astype(np.float32), wi.astype(np.float32)


def jax_ctx(seed=0, final_gather=True):
    rng = np.random.RandomState(seed)
    maps = {}
    for name, n, cell in (("caustic", 3000, 0.4), ("indirect", 4000, 0.8),
                          ("direct", 4000, 0.8)):
        maps[name] = j_map.build_photon_map(*surface_photons(rng, n), cell, target_k=40)
    vpos = rng.uniform([-3, -0.5, -3], [3, 3, 2], (6000, 3)).astype(np.float32)
    vwi = rng.normal(size=(6000, 3)).astype(np.float32)
    vwi /= np.linalg.norm(vwi, axis=-1, keepdims=True)
    maps["volume"] = j_map.build_photon_map(vpos, rng.uniform(0, 1e-3, (6000, 30)).astype(
        np.float32), vwi, 0.6, target_k=30)
    rpos, rlo, _ = surface_photons(rng, 3000)
    rn = np.where(rpos[:, 1:2] < -0.49, [[0.0, 1.0, 0.0]], [[0.0, 0.0, -1.0]]).astype(np.float32)
    rn[::7] *= -1.0                      # some face away: the hemisphere test
    maps["radiance"] = j_map.build_radiance_map(rpos, rlo * 50.0, rn, 0.8)
    return JCtx(caustic=maps["caustic"], indirect=maps["indirect"], volume=maps["volume"],
                direct=maps["direct"], radiance=maps["radiance"], n_caustic_paths=10000,
                n_indirect_paths=10000, n_volume_paths=10000, n_used=40, max_dist2=0.16,
                vol_n_used=30, vol_max_dist2=0.36, final_gather=final_gather,
                gather_samples=8, cos_gather_angle=float(np.cos(np.deg2rad(10.0))),
                max_specular_depth=5, max_photon_depth=5)


def ctx_arrays(ctx) -> dict:
    """A JAX PhotonCtx as the bridge's NumPy arrays."""
    out = {f"ctx.{k}": np.asarray(getattr(ctx, k)) for k in bridge.PHOTON_SETTINGS}
    for name in bridge.PHOTON_MAPS:
        m = getattr(ctx, name)
        if m is not None:
            out.update({f"{name}.{k}": np.asarray(v) for k, v in m._asdict().items()
                        if v is not None})
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = tmp_path_factory.mktemp("photon") / "scene.pbrt"
    path.write_text(PHOTON_SCENE)
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    assert_compile_parity(js, ts)
    rng = np.random.RandomState(5)
    target = rng.uniform([-2.5, -0.5, -1.5], [2.5, 2.8, 2.0], (N, 3))
    target[:64] = rng.normal([0.4, 0.4, 0.0], 0.35, (64, 3))        # the glass sphere
    target[64:128, 1] = -0.5                                         # the floor
    o = np.tile([[0.0, 1.2, -5.0]], (N, 1))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    pixel = np.arange(N, dtype=np.int32) * 7 + 3
    sidx = np.zeros(N, np.int32)
    return js, ts, o, d, pixel, sidx


def rays(o, d):
    z = np.zeros(N, np.float32)
    return (JRay(o, d, z, np.full(N, 1e30, np.float32), z),
            Ray(*(torch.as_tensor(x) for x in (o, d, z, np.full(N, 1e30, np.float32), z))))


def assert_same_radiance(got, ref):
    ref = np.asarray(ref)
    assert np.all(np.isfinite(got)) and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


@pytest.mark.parametrize("final_gather", [True, False])
def test_li_photonmap_matches_jax(setup, final_gather):
    js, ts, o, d, pixel, sidx = setup
    jctx = jax_ctx(final_gather=final_gather)
    tctx = bridge.photon_ctx_from_arrays(ctx_arrays(jctx), "cpu")
    assert tctx.final_gather == final_gather and tctx.radiance.count == jctx.radiance.count
    jr, tr = rays(o, d)
    depth = 1 if final_gather else 3
    ref = j_pm.li_photonmap(js, jctx, jr, pixel, sidx, max_depth=depth, seed=1)
    got = t_pm.li_photonmap(ts, tctx, tr, torch.as_tensor(pixel).long(),
                            torch.as_tensor(sidx).long(), max_depth=depth, seed=1).numpy()
    assert_same_radiance(got, ref)


def test_li_photonvolume_matches_jax(setup):
    js, ts, o, d, pixel, sidx = setup
    jctx = jax_ctx()
    tctx = bridge.photon_ctx_from_arrays(ctx_arrays(jctx), "cpu")
    jr, tr = rays(o, d)
    t_surf, _ = j_driver._first_hit_t(js, jr)
    ref = j_pv.li_photonvolume(js, jctx, jr, t_surf, pixel, sidx, 12, seed=2)
    got = t_pv.li_photonvolume(ts, tctx, tr, torch.tensor(np.asarray(t_surf)),
                               torch.as_tensor(pixel).long(), torch.as_tensor(sidx).long(), 12,
                               seed=2)
    assert_same_radiance(got.L.numpy(), ref.L)
    np.testing.assert_allclose(got.Tr.numpy(), np.asarray(ref.Tr), rtol=1e-4)
    in_rainbow = t_pv.rainbow_mask(ts.volume, torch.as_tensor(o + 4.0 * d)).numpy()
    assert in_rainbow.any() and not in_rainbow.all()


def test_photon_integrators_are_ported(tmp_path):
    """photonmap, exphotonmap and photonvolume compile and pick the
    photon tile; the maps are built once."""
    assert t_driver.PHOTON_TILE_SAMPLES == 1 << 14
    path = tmp_path / "scene.pbrt"
    path.write_text(PHOTON_SCENE.replace('"photonmap"', '"exphotonmap"'))
    ro = _parse(t_api, t_parser, path)
    assert t_driver.uses_photons(ro)
    t_compile(ro, "cpu")


def test_photon_modules_import_no_jax():
    """In a fresh interpreter, the photon modules and integrators of the
    port load neither jax nor pbrt_tpu."""
    code = ("import sys\n"
            "import pbrt_tpu_torch.photon.map, pbrt_tpu_torch.photon.shooter\n"
            "import pbrt_tpu_torch.integrators.photonmap, pbrt_tpu_torch.integrators.photonvolume\n"
            "import pbrt_tpu_torch.renderers.driver, pbrt_tpu_torch.bridge\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pbrt_tpu')]\n"
            "assert not bad, bad\n")
    root = str(__import__("pathlib").Path(__file__).resolve().parents[1])
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   env={"PATH": "/usr/bin:/bin", "PYTHONPATH": root}, timeout=120)
