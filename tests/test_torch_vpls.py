"""igi's light-path precompute and VPL gather
(pbrt_tpu_torch/integrators/extra.py) against the JAX package's.

generate_vpls on the same compiled scene (tests/test_integrators.py's
BASE / WORLD): positions and normals within 1e-5, contributions within
1e-5 relative of the largest, the valid masks identical. li_igi on the
JAX package's VPL sets carried across by bridge.py: the render limits of
tests/test_torch_slice.py. The VPL set picked for each pixel from 0 to
2^20: identical (uint32 wrap-around).
"""
import numpy as np
import jax.numpy as jnp
import torch

from pbrt_tpu.integrators import extra as j_extra
from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu.scene.compile import compile_scene as j_compile
from pbrt_tpu_torch.integrators import extra as t_extra
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from pbrt_tpu_torch.scene.compile import compile_scene as t_compile
from test_integrators import BASE, WORLD
from test_torch_extra_integrators import assert_same_image
from test_torch_quadrics import assert_compile_parity
from test_torch_slice import _parse

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def test_generate_vpls_matches_jax(tmp_path):
    path = tmp_path / "scene.pbrt"
    path.write_text(BASE + WORLD)
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    assert_compile_parity(js, ts)
    ref = j_extra.generate_vpls(js, 3, 64, 4, seed=5)
    got = t_extra.generate_vpls(ts, 3, 64, 4, seed=5)
    valid = np.asarray(ref.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    # VPLs at three depths or more; most light paths leave the open scene
    assert 0 < valid.mean() < 0.5 and valid.reshape(3, 64, 4).any((0, 1)).sum() >= 3
    for f in ("p", "n"):
        np.testing.assert_allclose(getattr(got, f).numpy()[valid],
                                   np.asarray(getattr(ref, f))[valid], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    le = np.asarray(ref.le)
    np.testing.assert_allclose(got.le.numpy(), le, rtol=1e-5, atol=1e-5 * le.max())


def test_igi_set_index_matches_jax():
    """(pixel * 2654435761) wraps in uint32 from pixel 2 on; the set index
    is (that >> 8) mod nsets, as extra.py:146 of the JAX package forms it."""
    pix = np.arange((1 << 20) + 1, dtype=np.int64)
    for n_sets in (2, 3, 4, 7):
        j_pix = jnp.asarray(pix, jnp.int32)
        ref = (j_pix.astype(jnp.uint32) * jnp.uint32(2654435761) >> 8) % jnp.uint32(n_sets)
        got = t_extra.igi_set_index(torch.as_tensor(pix), n_sets)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))
        want = ((pix.astype(np.uint64) * 2654435761) % (1 << 32) >> 8) % n_sets
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_igi_on_identical_vpls_matches_jax(tmp_path):
    """The JAX package's VPL sets carried across by bridge.py: li_igi on
    256 camera rays over the sphere and the disk, against the JAX
    package's on the same sets (the render limits above)."""
    from pbrt_tpu.core.geometry import Ray as JRay
    from pbrt_tpu_torch import bridge
    from pbrt_tpu_torch.core.geometry import Ray

    path = tmp_path / "scene.pbrt"
    path.write_text(BASE + WORLD)
    js = j_compile(_parse(j_api, j_parser, path))
    ts = t_compile(_parse(t_api, t_parser, path), "cpu")
    j_vpls = j_extra.generate_vpls(js, 2, 3, 2, seed=1)
    t_vpls = bridge.vpls_from_arrays(bridge.tuple_to_arrays(j_vpls, "vpls"), "cpu")
    rng = np.random.RandomState(2)
    N = 256
    o = np.tile([[0.0, 1.0, -3.0]], (N, 1)).astype(np.float32)
    d = np.stack([rng.uniform(-0.6, 0.6, N), rng.uniform(-0.8, 0.1, N), np.ones(N)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    pix = np.arange(N, dtype=np.int32) * 7
    ref = np.asarray(j_extra.li_igi(
        js, j_vpls, JRay(jnp.asarray(o), jnp.asarray(d), jnp.zeros(N), jnp.full((N,), 1e30),
                         jnp.zeros(N)), jnp.asarray(pix), jnp.zeros(N, jnp.int32), seed=3))
    got = t_extra.li_igi(ts, t_vpls, Ray(torch.as_tensor(o), torch.as_tensor(d), torch.zeros(N),
                                         torch.full((N,), 1e30), torch.zeros(N)),
                         torch.as_tensor(pix, dtype=torch.int64),
                         torch.zeros(N, dtype=torch.int64), seed=3).numpy()
    assert np.asarray(j_vpls.valid).any() and ref.mean() > 0
    assert_same_image(got[None], ref[None])
