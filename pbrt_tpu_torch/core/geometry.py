"""Vector/ray math on batched `[..., 3]` tensors.

Port of the parts of pbrt_tpu/core/geometry.py the main path uses. A
"vector" is any float32 tensor shaped [..., 3]; rays are a NamedTuple
of tensors with a leading batch axis. Cross products and dots are
written out componentwise in the reference's operation order.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def dot(a, b):
    return torch.sum(a * b, -1)


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], -1)


def length(v):
    return torch.sqrt(torch.sum(v * v, -1))


def normalize(v, eps: float = 1e-20):
    """Safe normalize; zero vectors map to zero."""
    n2 = torch.sum(v * v, -1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=eps))
    return v * torch.where(n2 > eps, inv, torch.zeros((), device=v.device))


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


class Ray(NamedTuple):
    """A wavefront of rays: o/d [N, 3], tmin/tmax/time [N]."""

    o: torch.Tensor
    d: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor
    time: torch.Tensor
