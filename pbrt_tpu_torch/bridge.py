"""Compiled-scene tensors <-> flat dicts of NumPy arrays.

The JAX package's compiled scene, handed over as a dict of NumPy arrays,
becomes this package's tensors (`from_arrays`), and this package's
compiled scene flattens to the same keys (`to_arrays`). The tests use
it to feed both packages identical geometry (triangles and quadrics),
lights, light CDF, wide BVH and volume regions, and to compare their
compilers array for array. Keys are "<part>.<field>" with the field
names of pbrt_tpu's SceneGeom (with its packs), LightsT, Distribution1D,
WideBVH and VolumeT.
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.accel.intersect import SceneGeom
from pbrt_tpu_torch.accel.wide_bvh import WideBVH
from pbrt_tpu_torch.core.sampling import Distribution1D
from pbrt_tpu_torch.lights.lighting import LightsT
from pbrt_tpu_torch.volumes.registry import VolumeT

GEOM_FIELDS = {
    "tri_v0": torch.float32, "tri_e1": torch.float32, "tri_e2": torch.float32,
    "tri_n": torch.float32, "tri_has_n": torch.bool, "tri_uv": torch.float32,
    "tri_mat": torch.int32, "tri_light": torch.int32, "world_lo": torch.float32,
    "world_hi": torch.float32, "tri_pack": torch.float32,
    "quad_type": torch.int32, "quad_o2w": torch.float32, "quad_w2o": torch.float32,
    "quad_params": torch.float32, "quad_mat": torch.int32, "quad_light": torch.int32,
    "quad_flip": torch.bool, "quad_pack": torch.float32,
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
VOLUME_FIELDS = {
    "kind": torch.int32, "w2v": torch.float32, "lo": torch.float32, "hi": torch.float32,
    "sigma_a": torch.float32, "sigma_s": torch.float32, "le": torch.float32,
    "g": torch.float32, "params": torch.float32, "grid": torch.float32,
    "grid_dims": torch.int32,
}
PARTS = {"geom": (SceneGeom, GEOM_FIELDS), "lights": (LightsT, LIGHT_FIELDS),
         "light_dist": (Distribution1D, DIST_FIELDS), "wide": (WideBVH, WIDE_FIELDS),
         "volume": (VolumeT, VOLUME_FIELDS)}


def from_arrays(arrays: dict, part: str, device):
    """Build one part ("geom", "lights", "light_dist", "wide" or
    "volume") from arrays["<part>.<field>"] on `device`; None if the
    part is absent. A geometry without quadric keys gets none."""
    cls, fields = PARTS[part]
    if f"{part}.{next(iter(fields))}" not in arrays:
        return None
    kw = {f: torch.tensor(np.asarray(arrays[f"{part}.{f}"]), dtype=dt)
          for f, dt in fields.items() if f"{part}.{f}" in arrays}
    if part == "volume":   # its region kinds and grid dims are also kept on the host
        return VolumeT.make(device, **kw)
    kw = {f: x.to(device) for f, x in kw.items()}
    if part == "wide":
        kw["n_blocks"] = int(arrays["wide.n_blocks"])
    if part == "geom" and "quad_type" in kw:
        kw["quad_present"] = frozenset(int(k) for k in np.asarray(arrays["geom.quad_type"]))
    return cls(**kw)


def to_arrays(part: str, obj) -> dict:
    """Flatten one part of this package's scene to "<part>.<field>" arrays
    (fields a hand-built part leaves at None are left out)."""
    if obj is None:
        return {}
    _, fields = PARTS[part]
    out = {f"{part}.{f}": getattr(obj, f).cpu().numpy() for f in fields
           if getattr(obj, f) is not None}
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
    out.update(to_arrays("volume", scene.volume))
    return out
