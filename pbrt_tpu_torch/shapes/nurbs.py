"""NURBS surfaces tessellated on the host (NumPy).

Port of pbrt_tpu/shapes/nurbs.py (reference shapes/nurbs.cpp):
Cox-de-Boor basis evaluation over the knot vectors, rational control
points given as homogeneous "Pw" or plain "P", diced to a regular grid
of triangles with normals from the grid's finite differences. The
TriangleData equals the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.core.error import warning
from pbrt_tpu_torch.core.transform import Transform, xform_point_affine, xform_normal


def _basis_funs(u, order, knots, n_ctrl):
    """All B-spline basis functions of given order at parameters u.

    u: [m]; returns [m, n_ctrl]. Degree = order - 1.
    """
    m = u.shape[0]
    deg = order - 1
    # zeroth-degree
    n = np.zeros((m, len(knots) - 1))
    for i in range(len(knots) - 1):
        n[:, i] = np.where((u >= knots[i]) & (u < knots[i + 1]), 1.0, 0.0)
    # ensure the last parameter value is included in the final span
    for i in range(len(knots) - 2, -1, -1):
        if knots[i] < knots[-1]:
            n[u >= knots[-1] - 1e-9, i] = 1.0
            break
    for d in range(1, deg + 1):
        n_new = np.zeros((m, len(knots) - 1 - d))
        for i in range(len(knots) - 1 - d):
            d1 = knots[i + d] - knots[i]
            d2 = knots[i + d + 1] - knots[i + 1]
            t1 = np.where(d1 > 0, (u - knots[i]) / np.where(d1 > 0, d1, 1.0), 0.0) * n[:, i]
            t2 = (np.where(d2 > 0, (knots[i + d + 1] - u) / np.where(d2 > 0, d2, 1.0), 0.0)
                  * n[:, i + 1])
            n_new[:, i] = t1 + t2
        n = n_new
    return n[:, :n_ctrl]


def make_nurbs(params, o2w: Transform, dice: int = 30):
    from pbrt_tpu_torch.shapes.registry import TriangleData

    nu = params.find_one_int("nu", -1)
    nv = params.find_one_int("nv", -1)
    uorder = params.find_one_int("uorder", -1)
    vorder = params.find_one_int("vorder", -1)
    uknots = params.find_float("uknots")
    vknots = params.find_float("vknots")
    u0 = params.find_one_float("u0", float(uknots[uorder - 1]) if uknots is not None else 0.0)
    u1 = params.find_one_float("u1", float(uknots[nu]) if uknots is not None else 1.0)
    v0 = params.find_one_float("v0", float(vknots[vorder - 1]) if vknots is not None else 0.0)
    v1 = params.find_one_float("v1", float(vknots[nv]) if vknots is not None else 1.0)
    if min(nu, nv, uorder, vorder) < 0 or uknots is None or vknots is None:
        warning("Must provide nu/nv/uorder/vorder/uknots/vknots for nurbs")
        return None
    p = params.find_point("P")
    if p is None:
        pw = params.find_float("Pw")
        if pw is None:
            warning("Must provide control points via \"P\" or \"Pw\" for nurbs")
            return None
        p = np.asarray(pw, np.float64).reshape(-1, 4)
    else:
        p = np.concatenate([p.astype(np.float64), np.ones((p.shape[0], 1))], axis=1)
    if p.shape[0] != nu * nv:
        warning("nurbs control point count mismatch")
        return None
    ctrl = p.reshape(nv, nu, 4)  # [v, u, 4]; "Pw" carries its weights in xyz already

    us = np.linspace(u0, u1 - 1e-7, dice)
    vs = np.linspace(v0, v1 - 1e-7, dice)
    bu = _basis_funs(us, uorder, np.asarray(uknots, np.float64), nu)  # [du, nu]
    bv = _basis_funs(vs, vorder, np.asarray(vknots, np.float64), nv)  # [dv, nv]
    # surface points: S[v,u] = sum_j sum_i bv[v,j] bu[u,i] ctrl[j,i]
    hpts = np.einsum("vj,ui,jik->vuk", bv, bu, ctrl)
    pts = hpts[..., :3] / np.maximum(hpts[..., 3:4], 1e-12)

    dv_, du_ = dice, dice
    uvg = np.stack(np.meshgrid((us - u0) / max(u1 - u0, 1e-9),
                               (vs - v0) / max(v1 - v0, 1e-9), indexing="xy"), axis=-1)
    uv = uvg.reshape(-1, 2).astype(np.float32)
    idx = []
    for j in range(dv_ - 1):
        for i in range(du_ - 1):
            a = j * du_ + i
            b = j * du_ + i + 1
            c = (j + 1) * du_ + i + 1
            d = (j + 1) * du_ + i
            idx.append([a, b, c])
            idx.append([a, c, d])
    flat = pts.reshape(-1, 3)
    # normals from grid finite differences
    dpdu = np.gradient(pts, axis=1)
    dpdv = np.gradient(pts, axis=0)
    n = np.cross(dpdu, dpdv).reshape(-1, 3)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    world_p = xform_point_affine(o2w.m, flat).astype(np.float32)
    world_n = xform_normal(o2w.m_inv, n).astype(np.float32)
    world_n = world_n / np.maximum(np.linalg.norm(world_n, axis=-1, keepdims=True), 1e-12)
    return TriangleData(p=world_p, indices=np.asarray(idx, np.int32), n=world_n, uv=uv)
