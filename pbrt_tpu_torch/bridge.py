"""Compiled-scene tensors <-> flat dicts of NumPy arrays.

The JAX package's compiled scene, handed over as a dict of NumPy arrays,
becomes this package's tensors (`from_arrays`), and this package's
compiled scene flattens to the same keys (`to_arrays`). The tests use
it to feed both packages identical geometry, lights, light CDF and
wide BVH, and to compare their compilers array for array. Keys are
"<part>.<field>" with the field names of pbrt_tpu's SceneGeom (with
its triangle pack), LightsT, Distribution1D and WideBVH.
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.accel.intersect import SceneGeom
from pbrt_tpu_torch.accel.wide_bvh import WideBVH
from pbrt_tpu_torch.core.sampling import Distribution1D
from pbrt_tpu_torch.lights.lighting import LightsT

GEOM_FIELDS = {
    "tri_v0": torch.float32, "tri_e1": torch.float32, "tri_e2": torch.float32,
    "tri_n": torch.float32, "tri_has_n": torch.bool, "tri_uv": torch.float32,
    "tri_mat": torch.int32, "tri_light": torch.int32, "world_lo": torch.float32,
    "world_hi": torch.float32, "tri_pack": torch.float32,
}
LIGHT_FIELDS = {
    "kind": torch.int32, "l2w": torch.float32, "w2l": torch.float32,
    "spectra": torch.float32, "params": torch.float32, "power": torch.float32,
    "n_samples": torch.int32, "al_v0": torch.float32, "al_e1": torch.float32,
    "al_e2": torch.float32, "al_cdf": torch.float32,
}
DIST_FIELDS = {"func": torch.float32, "cdf": torch.float32, "func_int": torch.float32}
WIDE_FIELDS = {
    "block_lo": torch.float32, "block_hi": torch.float32, "tris16": torch.float32,
    "prim_map": torch.int64, "world_lo": torch.float32, "world_hi": torch.float32,
}
PARTS = {"geom": (SceneGeom, GEOM_FIELDS), "lights": (LightsT, LIGHT_FIELDS),
         "light_dist": (Distribution1D, DIST_FIELDS), "wide": (WideBVH, WIDE_FIELDS)}


def from_arrays(arrays: dict, part: str, device):
    """Build one part ("geom", "lights", "light_dist" or "wide") from
    arrays["<part>.<field>"] on `device`; None if the part is absent."""
    cls, fields = PARTS[part]
    if f"{part}.{next(iter(fields))}" not in arrays:
        return None
    kw = {f: torch.tensor(np.asarray(arrays[f"{part}.{f}"]), dtype=dt, device=device)
          for f, dt in fields.items()}
    if part == "wide":
        kw["n_blocks"] = int(arrays["wide.n_blocks"])
    return cls(**kw)


def to_arrays(part: str, obj) -> dict:
    """Flatten one part of this package's scene to "<part>.<field>" arrays."""
    if obj is None:
        return {}
    _, fields = PARTS[part]
    out = {f"{part}.{f}": getattr(obj, f).cpu().numpy() for f in fields}
    if part == "wide":
        out["wide.n_blocks"] = np.asarray(obj.n_blocks)
    return out


def scene_to_arrays(scene) -> dict:
    """All parts of a compiled scene (pbrt_tpu_torch.scene.compile)."""
    out = {}
    out.update(to_arrays("geom", scene.geom))
    out.update(to_arrays("lights", scene.lights))
    out.update(to_arrays("light_dist", scene.light_dist))
    out.update(to_arrays("wide", scene.accel.wide))
    return out
