"""Transforms: host-side 4x4 matrix algebra + batched applies.

Port of pbrt_tpu/core/transform.py. The host `Transform` is NumPy
(float64, with cached inverse); the batched applies work on NumPy
arrays and torch tensors alike. The applies are explicit component
mul/adds (not matmuls), as in the reference, so they round op for op
like it. Animated transforms (motion blur) are not yet ported.
"""
from __future__ import annotations

import numpy as np
import torch


def _stack(xs, like):
    if isinstance(like, torch.Tensor):
        return torch.stack(xs, -1)
    return np.stack(xs, axis=-1)


def _apply33(m, v):
    """[..., 3, 3] x [..., 3] -> [..., 3] componentwise."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return _stack(
        [m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2] * z,
         m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2] * z,
         m[..., 2, 0] * x + m[..., 2, 1] * y + m[..., 2, 2] * z], v)


def xform_point_affine(m, p):
    """Apply assuming bottom row is [0,0,0,1] (no w-divide)."""
    return _apply33(m, p) + m[..., :3, 3]


def xform_vector(m, v):
    return _apply33(m, v)


def xform_normal(m_inv, n):
    """Normals transform by the inverse transpose (pass the INVERSE matrix)."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    m = m_inv
    return _stack(
        [m[..., 0, 0] * x + m[..., 1, 0] * y + m[..., 2, 0] * z,
         m[..., 0, 1] * x + m[..., 1, 1] * y + m[..., 2, 1] * z,
         m[..., 0, 2] * x + m[..., 1, 2] * y + m[..., 2, 2] * z], n)


class Transform:
    """Affine/projective transform with cached inverse (NumPy, host only)."""

    __slots__ = ("m", "m_inv")

    def __init__(self, m=None, m_inv=None):
        if m is None:
            m = np.eye(4, dtype=np.float64)
        m = np.asarray(m, dtype=np.float64).reshape(4, 4)
        if m_inv is None:
            m_inv = np.linalg.inv(m)
        self.m = m
        self.m_inv = np.asarray(m_inv, dtype=np.float64).reshape(4, 4)

    def inverse(self) -> "Transform":
        return Transform(self.m_inv, self.m)

    def __mul__(self, other: "Transform") -> "Transform":
        return Transform(self.m @ other.m, other.m_inv @ self.m_inv)

    def __repr__(self):
        return f"Transform({self.m.tolist()})"

    # -- constructors (reference core/transform.cpp) --

    @staticmethod
    def translate(delta) -> "Transform":
        d = np.asarray(delta, np.float64)
        m = np.eye(4)
        m[:3, 3] = d
        mi = np.eye(4)
        mi[:3, 3] = -d
        return Transform(m, mi)

    @staticmethod
    def scale(x, y, z) -> "Transform":
        m = np.diag([x, y, z, 1.0]).astype(np.float64)
        mi = np.diag([1.0 / x, 1.0 / y, 1.0 / z, 1.0])
        return Transform(m, mi)

    @staticmethod
    def rotate(deg, axis) -> "Transform":
        a = np.asarray(axis, np.float64)
        a = a / np.linalg.norm(a)
        s = np.sin(np.deg2rad(deg))
        c = np.cos(np.deg2rad(deg))
        m = np.eye(4)
        m[0, 0] = a[0] * a[0] + (1 - a[0] * a[0]) * c
        m[0, 1] = a[0] * a[1] * (1 - c) - a[2] * s
        m[0, 2] = a[0] * a[2] * (1 - c) + a[1] * s
        m[1, 0] = a[0] * a[1] * (1 - c) + a[2] * s
        m[1, 1] = a[1] * a[1] + (1 - a[1] * a[1]) * c
        m[1, 2] = a[1] * a[2] * (1 - c) - a[0] * s
        m[2, 0] = a[0] * a[2] * (1 - c) - a[1] * s
        m[2, 1] = a[1] * a[2] * (1 - c) + a[0] * s
        m[2, 2] = a[2] * a[2] + (1 - a[2] * a[2]) * c
        return Transform(m, m.T)

    @staticmethod
    def look_at(eye, look, up) -> "Transform":
        """camera-to-world (reference core/transform.cpp LookAt)."""
        eye = np.asarray(eye, np.float64)
        look = np.asarray(look, np.float64)
        up = np.asarray(up, np.float64)
        dir_ = look - eye
        dir_ = dir_ / np.linalg.norm(dir_)
        left = np.cross(up / np.linalg.norm(up), dir_)
        nl = np.linalg.norm(left)
        if nl < 1e-12:
            # up parallel to viewing direction: pick any perpendicular
            tmp = np.array([0.0, 0.0, 1.0]) if abs(dir_[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
            left = np.cross(tmp, dir_)
            nl = np.linalg.norm(left)
        left = left / nl
        new_up = np.cross(dir_, left)
        c2w = np.eye(4)
        c2w[:3, 0] = left
        c2w[:3, 1] = new_up
        c2w[:3, 2] = dir_
        c2w[:3, 3] = eye
        return Transform(c2w)

    @staticmethod
    def perspective(fov_deg, znear, zfar) -> "Transform":
        persp = np.array(
            [
                [1, 0, 0, 0],
                [0, 1, 0, 0],
                [0, 0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)],
                [0, 0, 1, 0],
            ],
            dtype=np.float64,
        )
        inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
        return Transform.scale(inv_tan, inv_tan, 1.0) * Transform(persp)
