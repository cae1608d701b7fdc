"""Scene compiler: host records -> device tensors.

Port of the slice of pbrt_tpu/scene/compile.py the main path needs:
triangle meshes, point and diffuse area lights, and the matte,
plastic, mirror and glass materials with constant textures. Everything
else a scene may use fails here with "not yet ported: <name>" — the
compiler never substitutes something else.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import PbrtError, info, warning
from pbrt_tpu_torch.core.sampling import Distribution1D
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.accel.intersect import SceneGeom, make_tri_pack
from pbrt_tpu_torch.lights.lighting import L_AREA, L_POINT, LightsT
from pbrt_tpu_torch.materials.bsdf import PORTED_KINDS, BsdfParams
from pbrt_tpu_torch.materials.registry import KIND_ID
from pbrt_tpu_torch.scene.records import MaterialRecord, RenderOptions, ShapeRecord
from pbrt_tpu_torch.shapes.registry import make_shape
from pbrt_tpu_torch.textures.registry import ConstantTexture

S = spec.N_BINS

_LIGHTS_NOT_PORTED = ("spot", "goniometric", "projection", "distant", "infinite",
                      "exinfinite")


def not_ported(what: str):
    raise PbrtError(f"not yet ported: {what}")


@dataclass
class CompiledScene:
    """Host container of the device tensors the renderer reads."""

    geom: SceneGeom
    lights: Optional[LightsT]
    light_dist: Optional[Distribution1D]   # power-weighted pick CDF
    materials: List[MaterialRecord]        # index aligns with tri_mat
    material_dispersive: torch.Tensor      # [M] bool
    world_lo: np.ndarray
    world_hi: np.ndarray
    accel: object = None                   # accel.bvh.BvhScene

    def intersect(self, ray, coherent=False):
        """coherent: the batch is beam-like (camera or shadow rays);
        selects the cheaper frustum cull. Only performance changes."""
        return self.accel.intersect(ray, coherent=coherent)

    def intersect_p(self, ray, coherent=False):
        return self.accel.intersect_p(ray, coherent=coherent)


def _material_index(mat: Optional[MaterialRecord], materials: List[MaterialRecord],
                    index: Dict[int, int]) -> int:
    if mat is None:
        return -1
    key = id(mat)
    if key not in index:
        _check_material(mat)
        index[key] = len(materials)
        materials.append(mat)
    return index[key]


def _check_material(mat: MaterialRecord):
    if mat.kind not in PORTED_KINDS:
        not_ported(f'material "{mat.kind}"')
    for slot, tex in mat.textures.items():
        if tex is None:
            continue
        if slot == "bumpmap":
            not_ported(f'bump mapping (material "{mat.kind}")')
        if not isinstance(tex, ConstantTexture):
            not_ported(f'non-constant texture for "{slot}" of material "{mat.kind}"')


def _check_options(ro: RenderOptions):
    if ro.renderer_name in ("metropolis", "aggregatetest", "surfacepoints", "createprobes"):
        not_ported(f'renderer "{ro.renderer_name}"')
    if ro.surf_integrator_name in ("directlighting", "whitted", "ambientocclusion", "igi",
                                   "irradiancecache", "dipolesubsurface", "diffuseprt",
                                   "glossyprt", "useprobes", "photonmap", "exphotonmap"):
        not_ported(f'surface integrator "{ro.surf_integrator_name}"')
    if ro.vol_integrator_name not in ("emission", "single", "none"):
        not_ported(f'volume integrator "{ro.vol_integrator_name}"')
    if ro.volume_regions:
        not_ported(f'volume "{ro.volume_regions[0].kind}"')
    if ro.accelerator_name in ("grid", "kdtree"):
        not_ported(f'accelerator "{ro.accelerator_name}"')


def compile_scene(ro: RenderOptions, device) -> CompiledScene:
    """Lower RenderOptions to device tensors (reference api.cpp:1197)."""
    _check_options(ro)
    materials: List[MaterialRecord] = []
    mat_index: Dict[int, int] = {}

    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n, tri_has_n, tri_uv = [], [], []
    tri_mat, tri_light = [], []

    # Area lights get one LightsT row per emitting shape record.
    area_rows = []
    al_v0, al_e1, al_e2, al_area = [], [], [], []

    def add_shape_record(srec: ShapeRecord, extra_xform: Optional[Transform] = None):
        if srec.animated is not None:
            not_ported("motion blur (animated transform)")
        if srec.alpha_tex is not None:
            not_ported("alpha masks")
        o2w = srec.o2w if extra_xform is None else (extra_xform * srec.o2w)
        sd = make_shape(srec.kind, srec.params, o2w, o2w.inverse(), srec.reverse_orientation)
        if sd is None:
            return
        mi = _material_index(srec.material, materials, mat_index)
        li = -1
        if srec.area_light is not None:
            p = srec.area_light.params
            ones = spec.from_rgb(np.ones(3, np.float32))
            lemit = np.asarray(p.find_one_spectrum("L", ones), np.float32)
            scale = np.asarray(p.find_one_spectrum("scale", ones), np.float32)
            li = len(area_rows)
            area_rows.append({
                "L": lemit * scale, "nsamples": p.find_one_int("nsamples", 1),
                "tri_start": sum(len(a) for a in al_v0), "tri_count": 0, "area": 0.0,
            })
        for tri in sd.triangles:
            p = tri.p
            idx = tri.indices
            v0 = p[idx[:, 0]]
            v1 = p[idx[:, 1]]
            v2 = p[idx[:, 2]]
            tri_v0.append(v0)
            tri_e1.append(v1 - v0)
            tri_e2.append(v2 - v0)
            if tri.n is not None:
                tri_n.append(np.stack([tri.n[idx[:, 0]], tri.n[idx[:, 1]], tri.n[idx[:, 2]]], 1))
                tri_has_n.append(np.ones(len(idx), bool))
            else:
                tri_n.append(np.zeros((len(idx), 3, 3), np.float32))
                tri_has_n.append(np.zeros(len(idx), bool))
            if tri.uv is not None:
                tri_uv.append(np.stack([tri.uv[idx[:, 0]], tri.uv[idx[:, 1]], tri.uv[idx[:, 2]]], 1))
            else:
                default_uv = np.asarray([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0]], np.float32)
                tri_uv.append(np.tile(default_uv[None], (len(idx), 1, 1)))
            tri_mat.append(np.full(len(idx), mi, np.int32))
            tri_light.append(np.full(len(idx), li, np.int32))
            if li >= 0:
                e1, e2 = v1 - v0, v2 - v0
                areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
                al_v0.append(v0)
                al_e1.append(e1)
                al_e2.append(e2)
                al_area.append(areas)
                area_rows[li]["tri_count"] += len(idx)
                area_rows[li]["area"] += float(areas.sum())

    for srec in ro.shapes:
        add_shape_record(srec)
    for inst in ro.instances:
        if inst.animated is not None:
            not_ported("motion blur (animated instance)")
        for srec in inst.shapes:
            add_shape_record(srec, extra_xform=inst.i2w)

    if tri_v0:
        TV0 = np.concatenate(tri_v0).astype(np.float32)
        TE1 = np.concatenate(tri_e1).astype(np.float32)
        TE2 = np.concatenate(tri_e2).astype(np.float32)
        TN = np.concatenate(tri_n).astype(np.float32)
        THN = np.concatenate(tri_has_n)
        TUV = np.concatenate(tri_uv).astype(np.float32)
        TM = np.concatenate(tri_mat)
        TL = np.concatenate(tri_light)
    else:
        TV0 = TE1 = TE2 = np.zeros((0, 3), np.float32)
        TN = np.zeros((0, 3, 3), np.float32)
        THN = np.zeros((0,), bool)
        TUV = np.zeros((0, 3, 2), np.float32)
        TM = TL = np.zeros((0,), np.int32)

    allp = np.concatenate([TV0, TV0 + TE1, TV0 + TE2])
    if not len(allp):
        allp = np.zeros((1, 3), np.float32)
    world_lo = allp.min(0) - 1e-3
    world_hi = allp.max(0) + 1e-3

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()

    geom = SceneGeom(
        tri_v0=dev(TV0), tri_e1=dev(TE1), tri_e2=dev(TE2), tri_n=dev(TN),
        tri_has_n=dev(THN), tri_uv=dev(TUV), tri_mat=dev(TM), tri_light=dev(TL),
        world_lo=dev(world_lo, torch.float32), world_hi=dev(world_hi, torch.float32),
        tri_pack=dev(make_tri_pack(TV0, TE1, TE2, TN, TUV, THN, TM, TL)),
    )
    lights, light_dist = _build_lights(ro, area_rows, al_v0, al_e1, al_e2, al_area, device)
    disp = np.asarray([m.dispersive() for m in materials], bool)
    info(f"compiled scene: {len(TV0)} tris, "
         f"{0 if lights is None else int(lights.kind.shape[0])} lights, "
         f"{len(materials)} materials")

    from pbrt_tpu_torch.accel.bvh import make_accel

    accel_name = ro.accelerator_name
    if accel_name not in ("bvh", "none"):
        warning(f'Accelerator "{accel_name}" unknown; using "bvh".')
        accel_name = "bvh"
    split = ro.accelerator_params.find_one_string("splitmethod", "sah")
    accel = make_accel(geom, split, force="flat" if accel_name == "none" else "")
    return CompiledScene(geom=geom, lights=lights, light_dist=light_dist,
                         materials=materials, material_dispersive=dev(disp),
                         world_lo=world_lo, world_hi=world_hi, accel=accel)


def _build_lights(ro: RenderOptions, area_rows, al_v0, al_e1, al_e2, al_area, device):
    """Lower light records + collected area-light rows to LightsT."""
    kinds, l2w, spectra, params, power, nsamples = [], [], [], [], [], []

    def add(kind, xform: Transform, spectrum, pr, pw, ns=1):
        kinds.append(kind)
        l2w.append(xform.m.astype(np.float32))
        spectra.append(np.asarray(spectrum, np.float32))
        p12 = np.zeros(12, np.float32)
        p12[: len(pr)] = pr
        params.append(p12)
        power.append(np.asarray(pw, np.float32))
        nsamples.append(ns)

    for rec in ro.lights:
        p = rec.params
        name = rec.kind
        if name in _LIGHTS_NOT_PORTED:
            not_ported(f'light "{name}"')
        if name != "point":
            warning(f'Light "{name}" unknown.')
            continue
        ns = p.find_one_int("nsamples", 1)
        ones = spec.from_rgb(np.ones(3, np.float32))
        sc = np.asarray(p.find_one_spectrum("scale", ones), np.float32)
        I = np.asarray(p.find_one_spectrum("I", ones), np.float32) * sc
        frm = np.asarray(p.find_one_point("from", [0, 0, 0]), np.float64)
        add(L_POINT, rec.l2w * Transform.translate(frm), I, [], 4.0 * np.pi * I, ns)
        p.report_unused(f'in light "{name}"')

    for row in area_rows:
        pr = [row["area"], 0.0, 0.0, 0.0, 0.0, 0.0, row["tri_start"], row["tri_count"]]
        add(L_AREA, Transform(), row["L"], pr, row["L"] * np.pi * row["area"],
            row["nsamples"])

    if not kinds:
        return None, None

    # area-light CDF within each segment (normalized per light)
    if al_v0:
        AV0 = np.concatenate(al_v0).astype(np.float32)
        AE1 = np.concatenate(al_e1).astype(np.float32)
        AE2 = np.concatenate(al_e2).astype(np.float32)
        AAR = np.concatenate(al_area).astype(np.float64)
        ACDF = np.zeros(len(AAR), np.float32)
        for row in area_rows:
            s, c = row["tri_start"], row["tri_count"]
            if c > 0:
                seg = AAR[s:s + c]
                ACDF[s:s + c] = (np.cumsum(seg) / max(seg.sum(), 1e-20)).astype(np.float32)
    else:
        AV0 = AE1 = AE2 = np.zeros((0, 3), np.float32)
        ACDF = np.zeros((0,), np.float32)

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()

    L2W = np.stack(l2w)
    lights = LightsT(
        kind=dev(kinds, torch.int32), l2w=dev(L2W),
        w2l=dev(np.stack([np.linalg.inv(m) for m in L2W]).astype(np.float32)),
        spectra=dev(np.stack(spectra)), params=dev(np.stack(params)),
        power=dev(np.stack(power)), n_samples=dev(nsamples, torch.int32),
        al_v0=dev(AV0), al_e1=dev(AE1), al_e2=dev(AE2), al_cdf=dev(ACDF),
    )
    # power-weighted light pick CDF (reference core/integrator.h:110)
    pw = np.stack([np.asarray(spec.y(np.asarray(p))) for p in power]).reshape(len(power))
    pw = np.maximum(pw, 1e-9)
    return lights, Distribution1D.make(dev(pw, torch.float32))


# ---------------------------------------------------------------------------
# Shading-time material evaluation

def eval_bsdf_params(scene: CompiledScene, hit) -> BsdfParams:
    """Per-hit BsdfParams from the unique-material list, masked select."""
    H = hit.p.shape[0]
    out = BsdfParams.none(H, hit.p.device)
    for mi, mat in enumerate(scene.materials):
        sel = hit.mat == mi
        p = _lower_material(mat, H, hit.p.device)
        out = BsdfParams(*(torch.where(sel.reshape((H,) + (1,) * (a.dim() - 1)), a, b)
                           for a, b in zip(p, out)))
    return out


def _tex_spec(mat, name, H, device, default=0.0):
    tex = mat.textures.get(name)
    if tex is None:
        return torch.full((H, S), default, device=device)
    v = torch.as_tensor(tex.value, dtype=torch.float32, device=device)
    if v.dim() == 0:
        return torch.full((H, S), float(v), device=device)
    return v.expand(H, S)


def _tex_float(mat, name, H, device, default=0.0):
    tex = mat.textures.get(name)
    value = default if tex is None else float(tex.value)
    return torch.full((H,), value, device=device)


def _lower_material(mat: MaterialRecord, H: int, device) -> BsdfParams:
    """One material record -> BsdfParams slots (see bsdf.material_lobes
    for the slot-per-kind conventions)."""
    kind = mat.kind
    zs = torch.zeros((H, S), device=device)
    zf = torch.zeros((H,), device=device)
    kd = ks = kr = kt = zs
    rough_u = zf
    eta = torch.full((H,), 1.5, device=device)
    vn = zf
    sigma = zf
    if kind == "matte":
        kd = _tex_spec(mat, "Kd", H, device, 0.5)
        sigma = _tex_float(mat, "sigma", H, device, 0.0)
    elif kind == "plastic":
        kd = _tex_spec(mat, "Kd", H, device, 0.25)
        ks = _tex_spec(mat, "Ks", H, device, 0.25)
        rough_u = _tex_float(mat, "roughness", H, device, 0.1)
    elif kind == "glass":
        kr = _tex_spec(mat, "Kr", H, device, 1.0)
        kt = _tex_spec(mat, "Kt", H, device, 1.0)
        eta = _tex_float(mat, "index", H, device, 1.5)
        vn = torch.full((H,), mat.consts.get("Vn", 0.0), device=device)
    elif kind == "mirror":
        kr = _tex_spec(mat, "Kr", H, device, 0.9)
    else:
        not_ported(f'material "{kind}"')
    return BsdfParams(kind=torch.full((H,), KIND_ID[kind], dtype=torch.int64, device=device),
                      kd=kd, ks=ks, kr=kr, kt=kt, rough_u=rough_u, eta=eta, vn=vn,
                      sigma=sigma)
