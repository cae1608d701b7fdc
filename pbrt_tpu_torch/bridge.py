"""Compiled-scene tensors <-> flat dicts of NumPy arrays.

The JAX package's compiled scene, handed over as a dict of NumPy arrays,
becomes this package's tensors (`from_arrays`), and this package's
compiled scene flattens to the same keys (`to_arrays`). The tests use
it to feed both packages identical geometry (triangles and quadrics,
with the motion fields of an animated scene), lights (with the image
side structures of the goniometric, projection and infinite lights),
light CDF, wide and binary BVHs, uniform grids, kd-trees and volume
regions, and to compare their compilers array for array. Keys are "<part>.<field>" with the
field names of pbrt_tpu's SceneGeom (with its packs), LightsT,
Distribution1D, WideBVH, BVH, Grid ("grid."), KdTree ("kd.") and
VolumeT; the EnvMaps are
"env<i>.<field>" (light_idx, kind, image, and the cond/marg tables of
the Distribution2D) with their count under "envs.count".

A photon context (the maps and settings of pbrt_tpu's PhotonCtx) comes
across by `photon_ctx_from_arrays`, with the JAX package's map layout
([P, 4] packed rows, [S, P] spectra) turned into this package's.

Shading inputs come across the same way: a hit batch and a ShadingGeom
from arrays (`hit_from_arrays`, `shading_geom_from_arrays`), material
records from arrays and back (`bsdf_from_arrays`, `tuple_to_arrays`:
BsdfParams or Lobes with their mix child under "mix2." and the
measured tables under "meas_tables").

The precomputed inputs of the igi, dipolesubsurface and useprobes
integrators come across as "<prefix>.<field>" arrays of either
package's VplSets (p, n, le, valid), SurfacePoints (p, n, area, E) and
ProbeGrid (lo, hi, dims, coeffs, lmax): `vpls_from_arrays`,
`surface_points_from_arrays`, `probe_grid_from_arrays`, and
`tuple_to_arrays` back.

Gradients' inputs: `diff_params_from_arrays` gives a DiffParams, and
`frozen_shoot_from_arrays` turns either package's FrozenShoot,
flattened by `frozen_shoot_to_arrays`, into this package's (indices,
positions, directions, each class's MapStructure, cfg), so both packages
can be differentiated over one frozen shoot.
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.accel.bvh import BVH
from pbrt_tpu_torch.accel.grid import Grid
from pbrt_tpu_torch.accel.kdtree import KdTree
from pbrt_tpu_torch.accel.intersect import Hit, SceneGeom
from pbrt_tpu_torch.accel.wide_bvh import WideBVH
from pbrt_tpu_torch.core.sampling import Distribution1D, Distribution2D
from pbrt_tpu_torch.integrators.extra import ProbeGrid, SurfacePoints, VplSets
from pbrt_tpu_torch.lights.lighting import EnvMap, LightsT
from pbrt_tpu_torch.materials.bsdf import BsdfParams
from pbrt_tpu_torch.photon.map import PhotonMap, RadianceMap
from pbrt_tpu_torch.photon.shooter import PhotonCtx
from pbrt_tpu_torch.textures.registry import ShadingGeom
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
# the motion fields of an animated scene's geometry (None in static
# scenes, so not part of GEOM_FIELDS); time0 and time1 are scalars
MOTION_FIELDS = {"tri_dv0": torch.float32, "tri_de1": torch.float32, "tri_de2": torch.float32,
                 "quad_o2w_end": torch.float32, "quad_w2o_end": torch.float32}
DIST_FIELDS = {"func": torch.float32, "cdf": torch.float32, "func_int": torch.float32}
BVH_FIELDS = {"node_lo": torch.float32, "node_hi": torch.float32, "node_meta": torch.int64,
              "prim_ids": torch.int64}
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
GRID_FIELDS = {"lo": torch.float32, "hi": torch.float32, "n_vox": torch.int64,
               "width": torch.float32, "voxel_off": torch.int64, "voxel_prims": torch.int64}
KD_FIELDS = {"lo": torch.float32, "hi": torch.float32, "node_split": torch.float32,
             "node_meta": torch.int64, "prim_ids": torch.int64}
PARTS = {"geom": (SceneGeom, GEOM_FIELDS), "lights": (LightsT, LIGHT_FIELDS),
         "light_dist": (Distribution1D, DIST_FIELDS), "wide": (WideBVH, WIDE_FIELDS),
         "volume": (VolumeT, VOLUME_FIELDS), "bvh": (BVH, BVH_FIELDS),
         "grid": (Grid, GRID_FIELDS), "kd": (KdTree, KD_FIELDS)}


def from_arrays(arrays: dict, part: str, device):
    """Build one part ("geom", "lights", "light_dist", "wide", "volume",
    "bvh", "grid" or "kd") from arrays["<part>.<field>"] on `device`; None if the
    part is absent. A geometry without quadric keys gets none, and one
    with motion keys gets the motion fields and shutter times; lights
    get the EnvMaps of "env<i>." keys."""
    cls, fields = PARTS[part]
    if f"{part}.{next(iter(fields))}" not in arrays:
        return None
    if part == "geom":
        fields = {**fields, **MOTION_FIELDS}
    kw = {f: torch.tensor(np.asarray(arrays[f"{part}.{f}"]), dtype=dt)
          for f, dt in fields.items() if f"{part}.{f}" in arrays}
    if part == "volume":   # its region kinds and grid dims are also kept on the host
        return VolumeT.make(device, **kw)
    kw = {f: x.to(device) for f, x in kw.items()}
    if part == "wide":
        kw["n_blocks"] = int(arrays["wide.n_blocks"])
    if part == "geom" and "quad_type" in kw:
        kw["quad_present"] = frozenset(int(k) for k in np.asarray(arrays["geom.quad_type"]))
    if part == "geom" and "geom.time0" in arrays:
        kw["time0"] = float(arrays["geom.time0"])
        kw["time1"] = float(arrays["geom.time1"])
    if part == "lights":
        kw["envs"] = envs_from_arrays(arrays, device)
    return cls(**kw)


def envs_from_arrays(arrays: dict, device) -> tuple:
    """The EnvMaps of "env<i>." keys (see envs_to_arrays)."""
    out = []
    for i in range(int(arrays.get("envs.count", 0))):
        def t(f):
            return torch.tensor(np.asarray(arrays[f"env{i}.{f}"]), dtype=torch.float32,
                                device=device)

        dist = Distribution2D(Distribution1D(t("cond_func"), t("cond_cdf"), t("cond_func_int")),
                              Distribution1D(t("marg_func"), t("marg_cdf"), t("marg_func_int")))
        out.append(EnvMap(light_idx=int(arrays[f"env{i}.light_idx"]),
                          kind=int(arrays[f"env{i}.kind"]), image=t("image"), dist=dist))
    return tuple(out)


def envs_to_arrays(envs, light_kind) -> dict:
    """Flatten the EnvMaps of either package ("env<i>.<field>", with
    "envs.count"); light_kind [L] gives each map's light kind."""
    def a(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)

    kinds = a(light_kind)
    out = {"envs.count": np.asarray(len(envs))}
    for i, env in enumerate(envs):
        out.update({f"env{i}.light_idx": np.asarray(env.light_idx),
                    f"env{i}.kind": np.asarray(kinds[env.light_idx]),
                    f"env{i}.image": a(env.image)})
        for part in ("cond", "marg"):
            d = getattr(env.dist, part)
            for f in ("func", "cdf", "func_int"):
                out[f"env{i}.{part}_{f}"] = a(getattr(d, f))
    return out


def to_arrays(part: str, obj) -> dict:
    """Flatten one part of this package's scene to "<part>.<field>" arrays
    (fields a hand-built part leaves at None are left out)."""
    if obj is None:
        return {}
    _, fields = PARTS[part]
    if part == "geom":
        fields = {**fields, **MOTION_FIELDS}

    def a(x):
        return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)

    out = {f"{part}.{f}": a(getattr(obj, f)) for f in fields if getattr(obj, f) is not None}
    if part == "wide":
        out["wide.n_blocks"] = np.asarray(obj.n_blocks)
    if part == "geom" and obj.has_motion:
        out["geom.time0"] = np.asarray(obj.time0)
        out["geom.time1"] = np.asarray(obj.time1)
    if part == "lights" and obj.envs:
        out.update(envs_to_arrays(obj.envs, obj.kind))
    return out


def scene_to_arrays(scene) -> dict:
    """All parts of a compiled scene (pbrt_tpu_torch.scene.compile),
    with the grid or kd-tree of a GridScene or KdScene."""
    out = {}
    out.update(to_arrays("geom", scene.geom))
    out.update(to_arrays("lights", scene.lights))
    out.update(to_arrays("light_dist", scene.light_dist))
    out.update(to_arrays("wide", scene.accel.wide))
    out.update(to_arrays("bvh", scene.accel.bvh))
    out.update(to_arrays("grid", getattr(scene.accel, "grid", None)))
    out.update(to_arrays("kd", getattr(scene.accel, "kd", None)))
    out.update(to_arrays("volume", scene.volume))
    return out


PHOTON_MAPS = ("caustic", "indirect", "volume", "direct", "radiance")
PHOTON_SETTINGS = ("n_caustic_paths", "n_indirect_paths", "n_volume_paths", "n_used",
                   "max_dist2", "vol_n_used", "vol_max_dist2", "final_gather",
                   "gather_samples", "cos_gather_angle", "max_specular_depth",
                   "max_photon_depth")


def photon_map_from_arrays(arrays: dict, name: str, device):
    """One map from arrays["<name>.<field>"], with the field names of
    pbrt_tpu's PhotonMap (pxyz, alpha_t, wixyz, cell_start, grid_lo,
    inv_cell, dims, count, occ) or RadianceMap (pxyz, lo_t, nxyz, ...);
    None if absent."""
    if f"{name}.pxyz" not in arrays:
        return None

    def t(field, dtype=torch.float32):
        return torch.tensor(np.asarray(arrays[f"{name}.{field}"]), dtype=dtype, device=device)

    def rows(field):   # [P, 4] packed rows -> [P, 3]
        return t(field)[:, :3].contiguous()

    spectra = "lo_t" if name == "radiance" else "alpha_t"
    common = dict(pos=rows("pxyz"), cell_start=t("cell_start", torch.int64),
                  grid_lo=t("grid_lo"), inv_cell=t("inv_cell"),
                  dims=tuple(int(x) for x in np.asarray(arrays[f"{name}.dims"])),
                  count=int(arrays[f"{name}.count"]))
    payload = t(spectra).T.contiguous()   # [S, P] -> [P, S]
    if name == "radiance":
        return RadianceMap(lo=payload, n=rows("nxyz"), **common)
    return PhotonMap(alpha=payload, wi=rows("wixyz"), occ=t("occ"), **common)


def photon_ctx_from_arrays(arrays: dict, device) -> PhotonCtx:
    """A PhotonCtx from the maps ("<map>.<field>", see
    photon_map_from_arrays) and settings ("ctx.<setting>") of pbrt_tpu's
    PhotonCtx."""
    maps = [photon_map_from_arrays(arrays, m, device) for m in PHOTON_MAPS]
    settings = {k: np.asarray(arrays[f"ctx.{k}"]).item() for k in PHOTON_SETTINGS}
    return PhotonCtx(*maps, **settings)


HIT_INT_FIELDS = ("mat", "light", "prim")


def hit_from_arrays(arrays: dict, device, prefix: str = "hit") -> Hit:
    """A hit batch from arrays["<prefix>.<field>"] with the field names of
    pbrt_tpu's Hit (valid, t, p, ng, ns, uv, dpdu, mat, light, prim)."""
    def t(f):
        dt = (torch.bool if f == "valid" else torch.int64 if f in HIT_INT_FIELDS
              else torch.float32)
        return torch.tensor(np.asarray(arrays[f"{prefix}.{f}"]), dtype=dt, device=device)

    return Hit(*(t(f) for f in Hit._fields))


def shading_geom_from_arrays(arrays: dict, device, prefix: str = "sg") -> ShadingGeom:
    """A ShadingGeom from arrays["<prefix>.<field>"] (p, uv, dpdx, dpdy,
    duvdx, duvdy)."""
    return ShadingGeom(*(torch.tensor(np.asarray(arrays[f"{prefix}.{f}"]), dtype=torch.float32,
                                      device=device) for f in ShadingGeom._fields))


def tuple_to_arrays(obj, prefix: str) -> dict:
    """Flatten a NamedTuple of arrays (BsdfParams, Lobes, BsdfSample or a
    Frame, of either package) to "<prefix>.<field>" NumPy arrays; a
    nested tuple (the mix child) goes under "<prefix>.<field>.", fields
    left at None are left out."""
    out = {}
    for f, v in obj._asdict().items():
        if v is None:
            continue
        if hasattr(v, "_asdict"):
            out.update(tuple_to_arrays(v, f"{prefix}.{f}"))
        else:
            out[f"{prefix}.{f}"] = np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
    return out


def bsdf_from_arrays(arrays: dict, device, prefix: str = "params") -> BsdfParams:
    """BsdfParams from tuple_to_arrays' keys (the JAX package's material
    records): kind and meas_id become int64, the mix child is rebuilt
    from "<prefix>.mix2." keys."""
    kw = {}
    for f in BsdfParams._fields:
        key = f"{prefix}.{f}"
        if f == "mix2":
            kw[f] = (bsdf_from_arrays(arrays, device, key)
                     if f"{key}.kind" in arrays else None)
        elif key in arrays:
            dt = torch.int64 if f in ("kind", "meas_id") else torch.float32
            kw[f] = torch.tensor(np.asarray(arrays[key]), dtype=dt, device=device)
        else:
            kw[f] = None
    return BsdfParams(**kw)


def _tensors(arrays: dict, prefix: str, fields, device, bool_fields=()):
    return {f: torch.tensor(np.asarray(arrays[f"{prefix}.{f}"]),
                            dtype=torch.bool if f in bool_fields else torch.float32,
                            device=device) for f in fields}


def vpls_from_arrays(arrays: dict, device, prefix: str = "vpls") -> VplSets:
    return VplSets(**_tensors(arrays, prefix, VplSets._fields, device, ("valid",)))


def surface_points_from_arrays(arrays: dict, device, prefix: str = "pts") -> SurfacePoints:
    return SurfacePoints(**_tensors(arrays, prefix, SurfacePoints._fields, device))


def probe_grid_from_arrays(arrays: dict, device, prefix: str = "probes") -> ProbeGrid:
    return ProbeGrid(**_tensors(arrays, prefix, ("lo", "hi", "coeffs"), device),
                     dims=tuple(int(x) for x in np.asarray(arrays[f"{prefix}.dims"])),
                     lmax=int(np.asarray(arrays[f"{prefix}.lmax"])))


def diff_params_from_arrays(arrays: dict, device, prefix: str = "params"):
    """diff.DiffParams from arrays["<prefix>.<field>"] (sigma_a, sigma_s,
    light_scale, kd_scale; absent fields stay None)."""
    from pbrt_tpu_torch.diff import DiffParams

    return DiffParams(**{f: torch.tensor(np.asarray(arrays[f"{prefix}.{f}"]),
                                         dtype=torch.float32, device=device)
                         for f in DiffParams._fields if f"{prefix}.{f}" in arrays})


FROZEN_SCALARS = ("n_batches", "B", "seed", "max_depth", "has_volume", "majorant")


def frozen_shoot_to_arrays(frozen, prefix: str = "frozen") -> dict:
    """Flatten either package's diff.FrozenShoot: its scalars, cfg
    ("<prefix>.cfg.<key>") and each class's idx, pos, wi, nshot and
    MapStructure ("<prefix>.c<code>.<field>", "...st.<field>")."""
    out = {f"{prefix}.{f}": np.asarray(getattr(frozen, f)) for f in FROZEN_SCALARS}
    out.update({f"{prefix}.cfg.{k}": np.asarray(v) for k, v in frozen.cfg.items()})
    for code, entry in frozen.classes.items():
        if entry is None:
            continue
        idx, pos, wi, st, nshot = entry
        c = f"{prefix}.c{code}"
        out.update({f"{c}.idx": np.asarray(idx), f"{c}.pos": np.asarray(pos),
                    f"{c}.wi": np.asarray(wi), f"{c}.nshot": np.asarray(nshot)})
        out.update({f"{c}.st.{f}": np.asarray(v) for f, v in st._asdict().items()})
    return out


def frozen_shoot_from_arrays(arrays: dict, prefix: str = "frozen"):
    """This package's diff.FrozenShoot from frozen_shoot_to_arrays' keys
    (the JAX package's frozen shoot carried across): a class without
    keys is empty (None)."""
    from pbrt_tpu_torch.diff import _CLASS_CODES, FrozenShoot
    from pbrt_tpu_torch.photon.map import MapStructure

    def a(key):
        return np.asarray(arrays[f"{prefix}.{key}"])

    classes = {}
    for code in _CLASS_CODES.values():
        c = f"c{code}"
        if f"{prefix}.{c}.idx" not in arrays:
            classes[code] = None
            continue
        st = MapStructure(order=a(f"{c}.st.order"), cell_start=a(f"{c}.st.cell_start"),
                          occ=a(f"{c}.st.occ"), lo=a(f"{c}.st.lo"),
                          inv_cell=a(f"{c}.st.inv_cell"),
                          dims=tuple(int(x) for x in a(f"{c}.st.dims")))
        classes[code] = (a(f"{c}.idx"), a(f"{c}.pos"), a(f"{c}.wi"), st,
                         int(a(f"{c}.nshot")))
    cfg = {k[len(prefix) + 5:]: a(k[len(prefix) + 1:]).item()
           for k in arrays if k.startswith(f"{prefix}.cfg.")}
    return FrozenShoot(n_batches=int(a("n_batches")), B=int(a("B")), seed=int(a("seed")),
                       max_depth=int(a("max_depth")), has_volume=bool(a("has_volume")),
                       majorant=float(a("majorant")), classes=classes, cfg=cfg)
