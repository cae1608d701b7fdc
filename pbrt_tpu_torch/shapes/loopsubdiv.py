"""Loop subdivision surfaces, tessellated on the host (NumPy).

Port of pbrt_tpu/shapes/loopsubdiv.py (reference shapes/loopsubdiv.cpp):
`nlevels` rounds of Loop subdivision with the valence-dependent beta
weights and the boundary rules, then limit-surface projection, emitting
a TriangleData soup; vectorized over edges and vertices. The
TriangleData equals the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.core.error import warning
from pbrt_tpu_torch.core.transform import Transform, xform_normal, xform_point_affine


def _beta(valence: np.ndarray) -> np.ndarray:
    # reference loopsubdiv.cpp ::beta (3/16 for valence 3 else 3/(8n))
    return np.where(valence == 3, 3.0 / 16.0, 3.0 / (8.0 * np.maximum(valence, 1)))


def _loop_gamma(valence: np.ndarray) -> np.ndarray:
    return 1.0 / (np.maximum(valence, 1) + 3.0 / (8.0 * _beta(valence)))


def _subdivide_once(p: np.ndarray, f: np.ndarray):
    """One round of Loop subdivision. p [V,3], f [F,3] -> (p', f')."""
    nv = p.shape[0]
    # edge table: for each undirected edge, its midpoint-vertex index
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    ekey = np.sort(edges, axis=1)
    uniq, inv = np.unique(ekey, axis=0, return_inverse=True)
    ne = uniq.shape[0]

    # adjacency: vertex valence and one-ring sums
    valence = np.zeros(nv, np.int64)
    ring_sum = np.zeros((nv, 3), np.float64)
    # each undirected unique edge contributes to both endpoints
    np.add.at(valence, uniq[:, 0], 1)
    np.add.at(valence, uniq[:, 1], 1)
    np.add.at(ring_sum, uniq[:, 0], p[uniq[:, 1]])
    np.add.at(ring_sum, uniq[:, 1], p[uniq[:, 0]])

    # boundary edges: appear in exactly one face
    counts = np.bincount(inv, minlength=ne)
    boundary_edge = counts == 1
    boundary_vert = np.zeros(nv, bool)
    boundary_vert[uniq[boundary_edge].ravel()] = True

    # even (old) vertex update: interior weighted ring, boundary 1/8 rule
    beta = _beta(valence)[:, None]
    new_even = (1.0 - valence[:, None] * beta) * p + beta * ring_sum
    # boundary: 3/4 v + 1/8 (two boundary neighbors)
    bsum = np.zeros((nv, 3), np.float64)
    bcnt = np.zeros(nv, np.int64)
    be = uniq[boundary_edge]
    np.add.at(bsum, be[:, 0], p[be[:, 1]])
    np.add.at(bsum, be[:, 1], p[be[:, 0]])
    np.add.at(bcnt, be[:, 0], 1)
    np.add.at(bcnt, be[:, 1], 1)
    b_new = 0.75 * p + 0.125 * bsum
    new_even = np.where((boundary_vert & (bcnt == 2))[:, None], b_new, new_even)

    # odd (edge) vertices: 3/8 endpoints + 1/8 opposite verts; boundary: midpoint
    opp_sum = np.zeros((ne, 3), np.float64)
    # face contributions: each face contributes its opposite vertex to each edge
    fe0 = inv[0: f.shape[0]]
    fe1 = inv[f.shape[0]: 2 * f.shape[0]]
    fe2 = inv[2 * f.shape[0]: 3 * f.shape[0]]
    np.add.at(opp_sum, fe0, p[f[:, 2]])
    np.add.at(opp_sum, fe1, p[f[:, 0]])
    np.add.at(opp_sum, fe2, p[f[:, 1]])
    mid = 0.5 * (p[uniq[:, 0]] + p[uniq[:, 1]])
    interior = 0.375 * (p[uniq[:, 0]] + p[uniq[:, 1]]) + 0.125 * opp_sum
    new_odd = np.where(boundary_edge[:, None], mid, interior)

    new_p = np.concatenate([new_even, new_odd], axis=0)
    e0 = nv + fe0
    e1 = nv + fe1
    e2 = nv + fe2
    new_f = np.concatenate(
        [
            np.stack([f[:, 0], e0, e2], axis=1),
            np.stack([e0, f[:, 1], e1], axis=1),
            np.stack([e2, e1, f[:, 2]], axis=1),
            np.stack([e0, e1, e2], axis=1),
        ],
        axis=0,
    )
    return new_p, new_f.astype(np.int64)


def _limit_and_normals(p: np.ndarray, f: np.ndarray):
    """Push vertices to the limit surface and compute limit normals."""
    nv = p.shape[0]
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    ekey = np.sort(edges, axis=1)
    uniq, inv = np.unique(ekey, axis=0, return_inverse=True)
    valence = np.zeros(nv, np.int64)
    ring_sum = np.zeros((nv, 3), np.float64)
    np.add.at(valence, uniq[:, 0], 1)
    np.add.at(valence, uniq[:, 1], 1)
    np.add.at(ring_sum, uniq[:, 0], p[uniq[:, 1]])
    np.add.at(ring_sum, uniq[:, 1], p[uniq[:, 0]])
    gamma = _loop_gamma(valence)[:, None]
    limit = (1.0 - valence[:, None] * gamma) * p + gamma * ring_sum
    # normals: area-weighted face normals (robust, avoids ring ordering)
    fn = np.cross(p[f[:, 1]] - p[f[:, 0]], p[f[:, 2]] - p[f[:, 0]])
    n = np.zeros((nv, 3), np.float64)
    np.add.at(n, f[:, 0], fn)
    np.add.at(n, f[:, 1], fn)
    np.add.at(n, f[:, 2], fn)
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    return limit, n


def make_loop_subdiv(params, o2w: Transform):
    from pbrt_tpu_torch.shapes.registry import TriangleData

    nlevels = params.find_one_int("nlevels", 3)
    vi = params.find_int("indices")
    p = params.find_point("P")
    if vi is None or p is None:
        warning("Vertex indices and positions required for loopsubdiv")
        return None
    f = vi.reshape(-1, 3).astype(np.int64)
    pts = p.astype(np.float64)
    for _ in range(nlevels):
        pts, f = _subdivide_once(pts, f)
    pts, n = _limit_and_normals(pts, f)
    world_p = xform_point_affine(o2w.m, pts).astype(np.float32)
    world_n = xform_normal(o2w.m_inv, n).astype(np.float32)
    world_n = world_n / np.maximum(np.linalg.norm(world_n, axis=-1, keepdims=True), 1e-12)
    return TriangleData(p=world_p, indices=f.astype(np.int32), n=world_n)
