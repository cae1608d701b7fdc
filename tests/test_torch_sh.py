"""The port's spherical harmonics (pbrt_tpu_torch/core/sh.py) against the
JAX package's, and the port's versions of tests/test_sh_rotation.py.

Limits: basis values, projections and quadratures within 1e-6 (absolute
plus relative; float32 transcendentals of XLA and ATen differ by an ulp
or two); lambda_l and the rotation blocks (host float64, the same NumPy
code) exactly. The three rotation checks keep the limits of
tests/test_sh_rotation.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import sh as j_sh
from pbrt_tpu_torch.core import sh as t_sh

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def _dirs(n, seed):
    w = np.random.RandomState(seed).normal(size=(n, 3))
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    w[:4] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, -1, 0]]   # poles and the equator
    return w.astype(np.float32)


@pytest.mark.parametrize("lmax", [0, 1, 2, 4, 6])
def test_sh_evaluate_matches_jax(lmax):
    w = _dirs(512, lmax)
    got = t_sh.sh_evaluate(torch.as_tensor(w), lmax).numpy()
    ref = np.asarray(j_sh.sh_evaluate(jnp.asarray(w), lmax))
    assert got.shape == ref.shape == (512, t_sh.sh_terms(lmax))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_terms_index_lambda_and_quadrature_match_jax():
    for lmax in range(7):
        assert t_sh.sh_terms(lmax) == j_sh.sh_terms(lmax)
        np.testing.assert_array_equal(t_sh.lambda_l(lmax), j_sh.lambda_l(lmax))
        for l in range(lmax + 1):
            for m in range(-l, l + 1):
                assert t_sh.sh_index(l, m) == j_sh.sh_index(l, m)
    for n_th, n_ph in ((4, 8), (24, 48)):
        d_t, w_t = t_sh.sphere_quadrature(n_th, n_ph)
        d_j, w_j = j_sh.sphere_quadrature(n_th, n_ph)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    assert abs(float(w_t.sum()) - 4 * np.pi) < 1e-2   # the 24 x 48 rule's area of the sphere


def test_project_function_matches_jax():
    """A smooth spectral function of direction projected by the 24 x 48
    quadrature (the lights' projection in integrators/extra.py)."""
    d_t, w_t = t_sh.sphere_quadrature(24, 48)
    d = d_t.numpy()
    f = np.stack([np.exp(2.0 * d[:, 2]) + k * d[:, 0] ** 2 for k in range(30)], -1)
    f = f.astype(np.float32)
    got = t_sh.project_function(torch.as_tensor(f), d_t, w_t, 4).numpy()
    ref = np.asarray(j_sh.project_function(jnp.asarray(f), jnp.asarray(d), jnp.asarray(w_t.numpy()), 4))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_rotation_blocks_match_jax():
    rng = np.random.RandomState(5)
    R = _rot(rng.normal(size=3), 0.77)
    for a, b in zip(t_sh.sh_rotation_blocks(R, 6), j_sh.sh_rotation_blocks(R, 6)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t_sh.sh_rotation_matrix(R, 4), j_sh.sh_rotation_matrix(R, 4))
    c = rng.normal(size=(25, 3)).astype(np.float32)
    np.testing.assert_allclose(t_sh.rotate_sh(torch.as_tensor(c), R, 4).numpy(),
                               np.asarray(j_sh.rotate_sh(jnp.asarray(c), R, 4)),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_sh_rotation.py, on the port

def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    x, y, z = axis / np.linalg.norm(axis)
    c, s = np.cos(angle), np.sin(angle)
    C = 1 - c
    return np.array([
        [c + x * x * C, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, c + y * y * C, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, c + z * z * C],
    ])


def test_rotation_matches_function_rotation():
    """c' = M(R) c satisfies sum c'_i Y_i(w) = sum c_i Y_i(R^T w) for
    every direction w."""
    rng = np.random.RandomState(7)
    lmax = 4
    c = rng.normal(size=(t_sh.sh_terms(lmax),)).astype(np.float32)
    for _ in range(3):
        R = _rot(rng.normal(size=3), rng.uniform(0, 2 * np.pi))
        c_rot = t_sh.rotate_sh(torch.as_tensor(c), R, lmax).numpy()
        w = rng.normal(size=(64, 3))
        w /= np.linalg.norm(w, axis=-1, keepdims=True)
        Yw = t_sh.sh_evaluate(torch.as_tensor(w, dtype=torch.float32), lmax).numpy()
        YRtw = t_sh.sh_evaluate(torch.as_tensor(w @ R, dtype=torch.float32), lmax).numpy()
        np.testing.assert_allclose(Yw @ c_rot, YRtw @ c, rtol=2e-4, atol=2e-4)


def test_rotation_blocks_are_orthogonal():
    R = _rot(np.random.RandomState(3).normal(size=3), 1.234)
    for l, bl in enumerate(t_sh.sh_rotation_blocks(R, 5)):
        np.testing.assert_allclose(bl @ bl.T, np.eye(2 * l + 1), atol=1e-10,
                                   err_msg=f"band {l}")


def test_zh_reprojection_is_exact_rotation():
    """A zonal lobe rotated by the full machinery equals its
    re-projection z_l sqrt(4pi/(2l+1)) Y_lm(axis), the identity
    glossyprt relies on."""
    rng = np.random.RandomState(11)
    lmax = 4
    z = rng.rand(lmax + 1)
    c = np.zeros(t_sh.sh_terms(lmax), np.float32)
    for l in range(lmax + 1):
        c[t_sh.sh_index(l, 0)] = z[l]
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    zhat = np.array([0.0, 0.0, 1.0])
    v = np.cross(zhat, axis)
    s = np.linalg.norm(v)
    R = np.eye(3) if s < 1e-12 else _rot(v, np.arctan2(s, float(zhat @ axis)))
    c_rot = t_sh.rotate_sh(torch.as_tensor(c), R, lmax).numpy()
    Ya = t_sh.sh_evaluate(torch.as_tensor(axis[None, :], dtype=torch.float32), lmax).numpy()[0]
    c_zh = np.zeros(t_sh.sh_terms(lmax))
    for l in range(lmax + 1):
        for m in range(-l, l + 1):
            i = t_sh.sh_index(l, m)
            c_zh[i] = z[l] * np.sqrt(4.0 * np.pi / (2 * l + 1)) * Ya[i]
    np.testing.assert_allclose(c_rot, c_zh, rtol=1e-3, atol=1e-4)
