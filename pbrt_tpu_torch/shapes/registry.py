"""Shape factory: plugin name + params -> triangles and/or quadric records.

Port of pbrt_tpu/shapes/registry.py (reference core/api.cpp:321-361
MakeShape and shapes/*.cpp) for every shape it knows. Two lowered
representations:

- TriangleData: world-space triangle soup with optional shading normals
  and uvs (reference shapes/trianglemesh.cpp); the heightfield, Loop
  subdivision surfaces (shapes/loopsubdiv.py) and NURBS patches
  (shapes/nurbs.py) are tessellated into it on the host.
- QuadricData: analytic quadrics kept exact (sphere, cylinder, disk,
  cone, paraboloid, hyperboloid) with object-to-world transforms and the
  standard pbrt partial ranges (zmin/zmax/phimax, disk innerradius),
  intersected analytically (accel/intersect.py).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pbrt_tpu_torch.core.error import PbrtError, warning
from pbrt_tpu_torch.core.transform import Transform, xform_point_affine, xform_normal
from pbrt_tpu_torch.scene.paramset import ParamSet

QUAD_SPHERE, QUAD_CYLINDER, QUAD_DISK, QUAD_CONE, QUAD_PARABOLOID, QUAD_HYPERBOLOID = range(6)


@dataclass
class TriangleData:
    p: np.ndarray                       # [n, 3] world space
    indices: np.ndarray                 # [t, 3] int32
    n: Optional[np.ndarray] = None      # [n, 3] shading normals (world)
    uv: Optional[np.ndarray] = None     # [n, 2]
    alpha_tex: object = None


@dataclass
class QuadricData:
    qtype: int
    o2w: np.ndarray                     # [4, 4]
    w2o: np.ndarray
    params: np.ndarray                  # [8]: radius zmin zmax phimax p4 p5
    reverse_orientation: bool = False
    swaps_handedness: bool = False


@dataclass
class ShapeData:
    triangles: List[TriangleData] = field(default_factory=list)
    quadrics: List[QuadricData] = field(default_factory=list)


def _clamped_z(params: ParamSet, radius: float):
    zmin = params.find_one_float("zmin", -radius)
    zmax = params.find_one_float("zmax", radius)
    return min(zmin, zmax), max(zmin, zmax)


def _phimax(params: ParamSet):
    return np.deg2rad(np.clip(params.find_one_float("phimax", 360.0), 0, 360))


def make_shape(name: str, params: ParamSet, o2w: Transform, w2o: Transform,
               reverse_orientation: bool) -> Optional[ShapeData]:
    sd = ShapeData()
    sw = o2w.swaps_handedness()

    def quad(qtype, p8):
        arr = np.zeros(8, np.float32)
        arr[: len(p8)] = p8
        sd.quadrics.append(
            QuadricData(qtype, o2w.m.astype(np.float32), w2o.m.astype(np.float32), arr,
                        reverse_orientation, sw))

    if name == "sphere":
        r = params.find_one_float("radius", 1.0)
        zmin, zmax = _clamped_z(params, r)
        zmin, zmax = max(zmin, -r), min(zmax, r)
        quad(QUAD_SPHERE, [r, zmin, zmax, _phimax(params)])
    elif name == "cylinder":
        r = params.find_one_float("radius", 1.0)
        zmin = params.find_one_float("zmin", -1.0)
        zmax = params.find_one_float("zmax", 1.0)
        quad(QUAD_CYLINDER, [r, min(zmin, zmax), max(zmin, zmax), _phimax(params)])
    elif name == "disk":
        height = params.find_one_float("height", 0.0)
        r = params.find_one_float("radius", 1.0)
        inner = params.find_one_float("innerradius", 0.0)
        quad(QUAD_DISK, [r, height, 0.0, _phimax(params), inner])
    elif name == "cone":
        r = params.find_one_float("radius", 1.0)
        height = params.find_one_float("height", 1.0)
        quad(QUAD_CONE, [r, 0.0, height, _phimax(params), height])
    elif name == "paraboloid":
        r = params.find_one_float("radius", 1.0)
        zmin = params.find_one_float("zmin", 0.0)
        zmax = params.find_one_float("zmax", 1.0)
        quad(QUAD_PARABOLOID, [r, min(zmin, zmax), max(zmin, zmax), _phimax(params), zmax])
    elif name == "hyperboloid":
        p1 = params.find_one_point("p1", [0, 0, 0])
        p2 = params.find_one_point("p2", [1, 1, 1])
        phimax = _phimax(params)
        # implicit coefficients a, c of a(x^2+y^2) - c z^2 = 1 through both
        # points (reference shapes/hyperboloid.cpp)
        pp1, pp2 = np.asarray(p1, np.float64), np.asarray(p2, np.float64)
        if pp1[2] == 0.0:
            pp1, pp2 = pp2, pp1
        A = np.array([[pp1[0] ** 2 + pp1[1] ** 2, -(pp1[2] ** 2)],
                      [pp2[0] ** 2 + pp2[1] ** 2, -(pp2[2] ** 2)]])
        try:
            ac = np.linalg.solve(A, np.ones(2))
        except np.linalg.LinAlgError:
            warning("degenerate hyperboloid; skipping")
            return sd
        rmax = max(np.hypot(pp1[0], pp1[1]), np.hypot(pp2[0], pp2[1]))
        quad(QUAD_HYPERBOLOID, [rmax, min(pp1[2], pp2[2]), max(pp1[2], pp2[2]), phimax,
                                float(ac[0]), float(ac[1])])
    elif name in ("trianglemesh", "heightfield", "loopsubdiv", "nurbs"):
        if name == "trianglemesh":
            tri = _make_triangle_mesh(params, o2w, reverse_orientation)
        elif name == "heightfield":
            tri = _make_heightfield(params, o2w)
        elif name == "loopsubdiv":
            from pbrt_tpu_torch.shapes.loopsubdiv import make_loop_subdiv

            tri = make_loop_subdiv(params, o2w)
        else:
            from pbrt_tpu_torch.shapes.nurbs import make_nurbs

            tri = make_nurbs(params, o2w)
        if tri is not None:
            sd.triangles.append(tri)
    else:
        warning(f'Shape "{name}" unknown.')
        return None
    params.report_unused(f'in shape "{name}"')
    return sd


def _make_triangle_mesh(params: ParamSet, o2w: Transform,
                        reverse_orientation: bool) -> Optional[TriangleData]:
    """reference shapes/trianglemesh.cpp:379-437 CreateTriangleMeshShape."""
    vi = params.find_int("indices")
    p = params.find_point("P")
    if vi is None or p is None:
        warning("Vertex indices and positions required for trianglemesh")
        return None
    uvs = params.find_float("uv")
    if uvs is None:
        uvs = params.find_float("st")
    n = params.find_normal("N")
    s = params.find_vector("S")
    if uvs is not None:
        uvs = np.asarray(uvs, np.float32).reshape(-1, 2)
        if uvs.shape[0] < p.shape[0]:
            warning("Not enough of \"uv\"s for triangle mesh; discarding")
            uvs = None
    if vi.max() >= p.shape[0]:
        warning("trianglemesh has out of-bounds vertex index; discarding")
        return None
    world_p = xform_point_affine(o2w.m, p.astype(np.float64)).astype(np.float32)
    world_n = None
    if n is not None:
        world_n = xform_normal(o2w.m_inv, n.astype(np.float64)).astype(np.float32)
        norms = np.linalg.norm(world_n, axis=-1, keepdims=True)
        world_n = world_n / np.maximum(norms, 1e-12)
        if reverse_orientation:
            world_n = -world_n
    alpha = None
    # alpha texture name is resolved by compile (needs graphics state); the
    # "alpha" float param is honored as a constant cutoff
    return TriangleData(
        p=world_p, indices=vi.reshape(-1, 3).astype(np.int32), n=world_n, uv=uvs,
        alpha_tex=None,
    )


def _make_heightfield(params: ParamSet, o2w: Transform) -> Optional[TriangleData]:
    """reference shapes/heightfield.cpp: an nu x nv grid of heights Pz
    over the unit square -> two triangles a cell."""
    nu = params.find_one_int("nu", -1)
    nv = params.find_one_int("nv", -1)
    pz = params.find_float("Pz")
    if nu == -1 or nv == -1 or pz is None:
        warning("Must provide nu, nv, and Pz for heightfield")
        return None
    if len(pz) != nu * nv:
        raise PbrtError(f"heightfield: {len(pz)} Pz values for nu x nv = {nu * nv}")
    x, yv = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv), indexing="xy")
    pts = np.stack([x.ravel(), yv.ravel(), np.asarray(pz, np.float32)], axis=-1)
    uv = np.stack([x.ravel(), yv.ravel()], axis=-1).astype(np.float32)
    j, i = np.meshgrid(np.arange(nv - 1), np.arange(nu - 1), indexing="ij")
    v00 = (j * nu + i).ravel()
    v10, v01 = v00 + 1, v00 + nu
    v11 = v01 + 1
    idx = np.stack([v00, v10, v11, v00, v11, v01], -1).reshape(-1, 3)
    world_p = xform_point_affine(o2w.m, pts.astype(np.float64)).astype(np.float32)
    return TriangleData(p=world_p, indices=idx.astype(np.int32), uv=uv)


def tessellate_quadric(q: QuadricData, n_phi: int = 64, n_v: int = 16):
    """Quadric -> world-space triangle soup (v0 [T,3], e1, e2, area [T])
    for area-light sampling: the light sampler draws from triangle
    tensors, so emitters other than full spheres are tessellated at
    compile time; intersection stays analytic.

    Triangle winding follows the pbrt (u=phi, v=z/theta) parameterization
    so cross(e1, e2) points along dpdu x dpdv (the shape normal), flipped
    by reverse_orientation ^ swaps_handedness like the analytic normal.
    """
    t = q.qtype
    r = float(q.params[0])
    p1, p2 = float(q.params[1]), float(q.params[2])
    phimax = float(q.params[3]) if q.params[3] > 0 else 2.0 * np.pi
    phis = np.linspace(0.0, phimax, n_phi + 1)
    vs = np.linspace(0.0, 1.0, n_v + 1)
    PH, V = np.meshgrid(phis, vs, indexing="ij")  # [n_phi+1, n_v+1]
    cph, sph = np.cos(PH), np.sin(PH)
    if t == QUAD_DISK:
        height, inner = p1, float(q.params[4])
        rad = r + (inner - r) * V
        x, y, z = rad * cph, rad * sph, np.full_like(V, height)
    elif t == QUAD_SPHERE:
        th0 = np.arccos(np.clip(p2 / r, -1.0, 1.0))  # zmax -> theta_min
        th1 = np.arccos(np.clip(p1 / r, -1.0, 1.0))
        th = th0 + (th1 - th0) * V
        x, y, z = r * np.sin(th) * cph, r * np.sin(th) * sph, r * np.cos(th)
    elif t == QUAD_CYLINDER:
        z = p1 + (p2 - p1) * V
        x, y = r * cph, r * sph
    elif t == QUAD_CONE:
        height = p2 if p2 != 0 else 1.0
        z = p1 + (p2 - p1) * V
        rad = r * (1.0 - z / height)
        x, y = rad * cph, rad * sph
    elif t == QUAD_PARABOLOID:
        zmax = p2 if p2 != 0 else 1.0
        z = p1 + (p2 - p1) * V
        rad = r * np.sqrt(np.clip(z / zmax, 0.0, None))
        x, y = rad * cph, rad * sph
    else:  # hyperboloid: linear lerp between end circles (approximate)
        z = p1 + (p2 - p1) * V
        rad = np.full_like(V, r)
        x, y = rad * cph, rad * sph
    pts = np.stack([x, y, z], -1).reshape(-1, 3)
    pts = xform_point_affine(np.asarray(q.o2w, np.float64), pts)
    pts = pts.reshape(n_phi + 1, n_v + 1, 3).astype(np.float32)

    A = pts[:-1, :-1].reshape(-1, 3)
    B = pts[1:, :-1].reshape(-1, 3)   # +u
    C = pts[:-1, 1:].reshape(-1, 3)   # +v
    D = pts[1:, 1:].reshape(-1, 3)
    v0 = np.concatenate([A, B])
    e1 = np.concatenate([B - A, D - B])
    e2 = np.concatenate([C - A, C - B])
    if bool(q.reverse_orientation) ^ bool(q.swaps_handedness):
        e1, e2 = e2, e1
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
    keep = area > 1e-12
    return v0[keep], e1[keep], e2[keep], area[keep].astype(np.float32)
