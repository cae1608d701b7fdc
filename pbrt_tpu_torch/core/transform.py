"""Transforms: host-side 4x4 matrix algebra + batched applies.

Port of pbrt_tpu/core/transform.py. The host `Transform` is NumPy
(float64, with cached inverse); the batched applies work on NumPy
arrays and torch tensors alike. The applies are explicit component
mul/adds (not matmuls), as in the reference, so they round op for op
like it. `AnimatedTransform` is the two-keyframe transform of motion
blur (decomposition into translation, rotation quaternion and scale,
slerped in `interpolate`); the renderer itself moves geometry by a
linear interpolation of the raw keyframe matrices, as the JAX package
does (accel/intersect.py SceneGeom.quad_xforms_at).
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


def xform_point(m, p):
    """Apply [..., 4, 4] matrix to point(s) [..., 3] (w-divide)."""
    r = _apply33(m, p) + m[..., :3, 3]
    w = (m[..., 3, 0] * p[..., 0] + m[..., 3, 1] * p[..., 1]
         + m[..., 3, 2] * p[..., 2] + m[..., 3, 3])
    return r / w[..., None]


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

    def __call__(self, p):
        return xform_point(self.m, np.asarray(p, np.float64))

    def vector(self, v):
        return xform_vector(self.m, np.asarray(v, np.float64))

    def normal(self, n):
        return xform_normal(self.m_inv, np.asarray(n, np.float64))

    def is_identity(self) -> bool:
        return np.allclose(self.m, np.eye(4))

    def swaps_handedness(self) -> bool:
        return float(np.linalg.det(self.m[:3, :3])) < 0.0

    def has_scale(self) -> bool:
        for i in range(3):
            la2 = float(np.sum(self.m[:3, i] ** 2))
            if la2 < 0.999 or la2 > 1.001:
                return True
        return False

    def __repr__(self):
        return f"Transform({self.m.tolist()})"

    def __eq__(self, other):
        return isinstance(other, Transform) and np.array_equal(self.m, other.m)

    def __hash__(self):
        return hash(self.m.tobytes())

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
    def rotate_x(deg) -> "Transform":
        return Transform.rotate(deg, [1.0, 0.0, 0.0])

    @staticmethod
    def rotate_y(deg) -> "Transform":
        return Transform.rotate(deg, [0.0, 1.0, 0.0])

    @staticmethod
    def rotate_z(deg) -> "Transform":
        return Transform.rotate(deg, [0.0, 0.0, 1.0])

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
    def orthographic(znear, zfar) -> "Transform":
        return Transform.scale(1.0, 1.0, 1.0 / (zfar - znear)) * Transform.translate(
            [0.0, 0.0, -znear])

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


# ---------------------------------------------------------------------------
# Quaternions ([..., 4] as (x, y, z, w))

def quat_from_matrix(m) -> np.ndarray:
    """Rotation matrix (3x3 or 4x4 upper-left) -> quaternion [x,y,z,w]."""
    m = np.asarray(m, np.float64)[:3, :3]
    tr = np.trace(m)
    q = np.zeros(4)
    if tr > 0.0:
        s = np.sqrt(tr + 1.0)
        q[3] = s / 2.0
        s = 0.5 / s
        q[0] = (m[2, 1] - m[1, 2]) * s
        q[1] = (m[0, 2] - m[2, 0]) * s
        q[2] = (m[1, 0] - m[0, 1]) * s
    else:
        i = int(np.argmax([m[0, 0], m[1, 1], m[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(m[i, i] - (m[j, j] + m[k, k]) + 1.0, 0.0))
        qv = np.zeros(3)
        qv[i] = s * 0.5
        if s != 0.0:
            s = 0.5 / s
        q[3] = (m[k, j] - m[j, k]) * s
        qv[j] = (m[j, i] + m[i, j]) * s
        qv[k] = (m[k, i] + m[i, k]) * s
        q[:3] = qv
    return q


def quat_to_matrix(q):
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3] acting on
    column vectors (the transpose of the reference's stored layout)."""
    xp = torch if isinstance(q, torch.Tensor) else np
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = xp.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y + z * w), 2 * (x * z - y * w),
        2 * (x * y - z * w), 1 - 2 * (x * x + z * z), 2 * (y * z + x * w),
        2 * (x * z + y * w), 2 * (y * z - x * w), 1 - 2 * (x * x + y * y),
    ], -1).reshape(tuple(q.shape[:-1]) + (3, 3))
    return xp.swapaxes(m, -1, -2)


def slerp(t, q1, q2):
    """Spherical lerp (reference core/quaternion.cpp Slerp), in float32
    torch."""
    t, q1, q2 = (torch.as_tensor(x, dtype=torch.float32) for x in (t, q1, q2))
    cos_theta = torch.sum(q1 * q2, -1)
    q2 = torch.where((cos_theta < 0.0)[..., None], -q2, q2)
    cos_theta = torch.abs(cos_theta)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    near = cos_theta > 0.9995
    safe = torch.where(near, torch.ones_like(sin_theta), sin_theta)
    w1 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    w2 = torch.where(near, t, torch.sin(t * theta) / safe)
    q = w1[..., None] * q1 + w2[..., None] * q2
    return q / torch.sqrt(torch.sum(q * q, -1, keepdim=True))


def decompose(m):
    """Affine 4x4 -> (T [3], R quat [4], S [3, 3]) by polar
    decomposition, iteratively averaging with the inverse transpose
    (reference core/transform.cpp AnimatedTransform::Decompose)."""
    m = np.asarray(m, np.float64)
    T = m[:3, 3].copy()
    M = m[:3, :3].copy()
    R = M.copy()
    for _ in range(100):
        Rnext = 0.5 * (R + np.linalg.inv(R.T))
        if np.max(np.abs(Rnext - R)) < 1e-10:
            R = Rnext
            break
        R = Rnext
    S = np.linalg.inv(R) @ M
    return T, quat_from_matrix(R), S


class AnimatedTransform:
    """Two-keyframe animated transform (reference core/transform.h:299):
    both keyframes and their times, decomposed once on the host."""

    def __init__(self, t0: Transform, time0: float, t1: Transform, time1: float):
        self.start, self.end = t0, t1
        self.time0, self.time1 = float(time0), float(time1)
        self.actually_animated = not np.allclose(t0.m, t1.m)
        self.T0, self.R0, self.S0 = decompose(t0.m)
        self.T1, self.R1, self.S1 = decompose(t1.m)

    def interpolate(self, time):
        """time: float or tensor [...] -> float32 matrices [..., 4, 4]
        (torch): T and S lerped, R slerped."""
        time = torch.as_tensor(time, dtype=torch.float32)
        if not self.actually_animated:
            return torch.as_tensor(self.start.m, dtype=torch.float32).expand(
                tuple(time.shape) + (4, 4)).clone()
        dt = torch.clamp((time - self.time0) / (self.time1 - self.time0), 0.0, 1.0)

        def f32(x):
            return torch.as_tensor(x, dtype=torch.float32)

        T = (1.0 - dt)[..., None] * f32(self.T0) + dt[..., None] * f32(self.T1)
        R = slerp(dt, f32(self.R0), f32(self.R1))
        S = (1.0 - dt)[..., None, None] * f32(self.S0) + dt[..., None, None] * f32(self.S1)
        m = torch.zeros(tuple(dt.shape) + (4, 4), dtype=torch.float32)
        m[..., :3, :3] = quat_to_matrix(R) @ S
        m[..., :3, 3] = T
        m[..., 3, 3] = 1.0
        return m

    def motion_bounds(self, lo, hi, nsteps: int = 16):
        """Conservative bbox of a bbox over the time interval (host)."""
        lo = np.asarray(lo, np.float64)
        hi = np.asarray(hi, np.float64)
        corners = np.array(
            [[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]], [lo[0], hi[1], lo[2]],
             [lo[0], lo[1], hi[2]], [hi[0], hi[1], lo[2]], [hi[0], lo[1], hi[2]],
             [lo[0], hi[1], hi[2]], [hi[0], hi[1], hi[2]]])
        out_lo = np.full(3, np.inf)
        out_hi = np.full(3, -np.inf)
        for i in range(nsteps):
            t = self.time0 + (self.time1 - self.time0) * i / max(nsteps - 1, 1)
            pts = xform_point_affine(self.interpolate(t).numpy(), corners)
            out_lo = np.minimum(out_lo, pts.min(axis=0))
            out_hi = np.maximum(out_hi, pts.max(axis=0))
        return out_lo, out_hi
