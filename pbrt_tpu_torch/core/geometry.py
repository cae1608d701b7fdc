"""Vector/ray/bbox math on batched `[..., 3]` tensors.

Port of pbrt_tpu/core/geometry.py. A "vector" is any float32 tensor
shaped [..., 3]; rays, ray differentials and boxes are NamedTuples of
tensors with leading batch axes. Cross products and dots are written
out componentwise in the reference's operation order. Functions of
tensors compute on their inputs' device; constructors without tensor
inputs (BBox.empty) take the device explicitly.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


def dot(a, b):
    return torch.sum(a * b, -1)


def absdot(a, b):
    return torch.abs(dot(a, b))


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def length_sq(v):
    return torch.sum(v * v, -1)


def length(v):
    return torch.sqrt(length_sq(v))


def normalize(v, eps: float = 1e-20):
    """Safe normalize; zero vectors map to zero."""
    n2 = torch.sum(v * v, -1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=eps))
    return v * torch.where(n2 > eps, inv, torch.zeros((), device=v.device))


def distance(a, b):
    return length(a - b)


def distance_sq(a, b):
    return length_sq(a - b)


def faceforward(n, v):
    """Flip n to lie in the hemisphere of v (reference core/geometry.h)."""
    return torch.where((dot(n, v) < 0.0)[..., None], -n, n)


def coordinate_system(v1):
    """Orthonormal frame around unit v1 (reference core/geometry.h
    CoordinateSystem, branch-free). Returns (v2, v3)."""
    x, y, z = v1[..., 0], v1[..., 1], v1[..., 2]
    use_x = torch.abs(x) > torch.abs(y)
    inv_a = 1.0 / torch.sqrt(
        torch.clamp(torch.where(use_x, x * x + z * z, y * y + z * z), min=1e-24))
    zero = torch.zeros_like(x)
    v2 = torch.where(
        use_x[..., None],
        torch.stack([-z * inv_a, zero, x * inv_a], -1),
        torch.stack([zero, z * inv_a, -y * inv_a], -1),
    )
    return v2, cross(v1, v2)


def spherical_direction(sintheta, costheta, phi):
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi), costheta], -1)


def spherical_direction_frame(sintheta, costheta, phi, x, y, z):
    return ((sintheta * torch.cos(phi))[..., None] * x
            + (sintheta * torch.sin(phi))[..., None] * y
            + costheta[..., None] * z)


def spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * math.pi, p)


def lerp(t, a, b):
    return (1.0 - t) * a + t * b


class Ray(NamedTuple):
    """A wavefront of rays: o/d [N, 3], tmin/tmax/time [N]."""

    o: torch.Tensor
    d: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    time: torch.Tensor

    def at(self, t):
        return self.o + t[..., None] * self.d

    @staticmethod
    def make(o, d, tmin=None, tmax=None, time=None):
        """Rays over the broadcast batch of o and d [..., 3] (float32, on
        o's device): tmin 0, tmax inf and time 0 unless given."""
        batch = torch.broadcast_shapes(o.shape[:-1], d.shape[:-1])
        dev = o.device

        def field(x, default):
            x = torch.full((), default) if x is None else torch.as_tensor(x)
            return torch.broadcast_to(x.to(device=dev, dtype=torch.float32), batch)

        return Ray(torch.broadcast_to(o, batch + (3,)).to(torch.float32),
                   torch.broadcast_to(d, batch + (3,)).to(device=dev, dtype=torch.float32),
                   field(tmin, 0.0), field(tmax, math.inf), field(time, 0.0))


class RayDifferential(NamedTuple):
    """Ray plus screen-space differentials (reference core/geometry.h:176)."""

    ray: Ray
    rx_o: torch.Tensor
    rx_d: torch.Tensor
    ry_o: torch.Tensor
    ry_d: torch.Tensor
    has_differentials: torch.Tensor  # [N] bool

    def scale(self, s):
        o, d = self.ray.o, self.ray.d
        return self._replace(rx_o=o + (self.rx_o - o) * s, rx_d=d + (self.rx_d - d) * s,
                             ry_o=o + (self.ry_o - o) * s, ry_d=d + (self.ry_d - d) * s)


class BBox(NamedTuple):
    """Axis-aligned box; lo/hi are [..., 3]."""

    lo: torch.Tensor
    hi: torch.Tensor

    @staticmethod
    def empty(shape=(), *, device):
        return BBox(torch.full(tuple(shape) + (3,), math.inf, device=device),
                    torch.full(tuple(shape) + (3,), -math.inf, device=device))

    def union_point(self, p):
        return BBox(torch.minimum(self.lo, p), torch.maximum(self.hi, p))

    def union(self, other):
        return BBox(torch.minimum(self.lo, other.lo), torch.maximum(self.hi, other.hi))

    def diagonal(self):
        return self.hi - self.lo

    def surface_area(self):
        d = torch.clamp(self.diagonal(), min=0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])

    def centroid(self):
        return 0.5 * (self.lo + self.hi)

    def bounding_sphere(self):
        c = self.centroid()
        rad = torch.where(torch.all(self.hi >= self.lo, -1), distance(c, self.hi),
                          torch.zeros((), device=c.device))
        return c, rad

    def inside(self, p):
        return torch.all((p >= self.lo) & (p <= self.hi), -1)

    def expand(self, delta):
        return BBox(self.lo - delta, self.hi + delta)

    def intersect_p(self, ray: Ray):
        """Slab test. Returns (hit, t0, t1) broadcast over the ray batch."""
        inv_d = 1.0 / ray.d  # inf on zero components is fine for the slab test
        t_lo = (self.lo - ray.o) * inv_d
        t_hi = (self.hi - ray.o) * inv_d
        t0 = torch.maximum(torch.amax(torch.minimum(t_lo, t_hi), -1), ray.tmin)
        t1 = torch.minimum(torch.amin(torch.maximum(t_lo, t_hi), -1), ray.tmax)
        return t0 <= t1, t0, t1
