"""Scene compiler: host records -> device tensors.

Port of the slice of pbrt_tpu/scene/compile.py the ported paths need:
triangle meshes and quadrics with alpha masks, animated (motion-blurred)
shapes and instances, every light kind (point, spot, goniometric,
projection, distant, infinite with its importance table, and diffuse
area lights on meshes and quadrics), volume regions, every material
kind with any texture, measured BRDF tables, and bump mapping.
The tessellated shapes (heightfield, loopsubdiv, nurbs) arrive as
triangle meshes. The accelerator is the scene's: "bvh" (the routing of
accel/bvh.py make_accel), "none" (no tree), "grid" or "kdtree"; an
unknown name warns and takes "bvh", as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import info, warning
from pbrt_tpu_torch.core.sampling import Distribution1D, Distribution2D
from pbrt_tpu_torch.core.transform import Transform, xform_point_affine
from pbrt_tpu_torch.core.geometry import Ray, cross, normalize
from pbrt_tpu_torch.accel.intersect import Hit, SceneGeom, make_quad_pack, make_tri_pack
from pbrt_tpu_torch.lights.lighting import (
    L_AREA,
    L_DISTANT,
    L_GONIO,
    L_INFINITE,
    L_POINT,
    L_PROJECTION,
    L_SPOT,
    EnvMap,
    LightsT,
)
from pbrt_tpu_torch.materials.bsdf import BsdfParams
from pbrt_tpu_torch.materials.registry import KIND_ID
from pbrt_tpu_torch.scene.records import MaterialRecord, RenderOptions, ShapeRecord
from pbrt_tpu_torch.shapes.registry import QUAD_SPHERE, make_shape, tessellate_quadric
from pbrt_tpu_torch.textures.registry import ShadingGeom
from pbrt_tpu_torch.volumes.registry import VolumeT, build_volumes

S = spec.N_BINS


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
    accel: object = None                   # BvhScene, GridScene or KdScene
    volume: Optional[VolumeT] = None
    kd_scale: object = None                # [M, S] albedo scale (diff.py); None: unscaled
    meas_tables: object = None             # [T,TH,TD,PD,3] measured BRDFs
    meas_index: dict = field(default_factory=dict)  # id(material) -> table row
    alpha_textures: list = field(default_factory=list)  # alpha masks (texture or float)
    tri_alpha: object = None               # [T] int64 row of alpha_textures (-1 none)
    light_sh: dict = field(default_factory=dict)   # lmax -> the lights' SH projection
    # (owner, key) -> a loop's CUDA graphs (core/graphs.py graphs_for:
    # PathGraphs, ShootGraphs); a copy starts without them
    graphs: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    # how many alpha-masked layers a single ray can punch through
    # (the reference's recursive skip is unbounded; 4 covers real scenes)
    ALPHA_LAYERS = 4

    @property
    def n_lights(self) -> int:
        return 0 if self.lights is None else int(self.lights.kind.shape[0])

    def _alpha_of(self, hit: Hit):
        """[R] alpha at each hit (1.0 for prims with no alpha texture).
        Reference shapes/trianglemesh.cpp:379-437: alpha evaluated at the
        hit's differential geometry; 0 means the hit is discarded."""
        T = self.geom.n_tris
        is_tri = hit.valid & (hit.prim >= 0) & (hit.prim < max(T, 1))
        ai = torch.where(is_tri, self.tri_alpha[torch.clamp(hit.prim, 0, max(T - 1, 0))],
                         torch.full((), -1, dtype=torch.int64, device=hit.t.device))
        a = torch.ones(hit.t.shape, device=hit.t.device)
        sg = ShadingGeom.at(hit.p, hit.uv)
        for k, tex in enumerate(self.alpha_textures):
            if isinstance(tex, float):
                v = torch.full_like(a, tex)
            else:
                v = tex.eval(sg).to(torch.float32).expand(a.shape)
            a = torch.where(ai == k, v, a)
        return a

    def _intersect_alpha(self, ray: Ray, coherent=False):
        """Closest hit skipping alpha == 0 surfaces: a bounded re-trace
        with tmin advanced past each masked hit. Each re-trace carries
        only the masked rays (the others get an empty interval and keep
        their hit)."""
        hit = self.accel.intersect(ray, coherent=coherent)
        tmin = ray.tmin
        empty = torch.full((), -1.0, device=ray.o.device)
        for _ in range(self.ALPHA_LAYERS):
            masked = hit.valid & (self._alpha_of(hit) <= 0.0)
            tmin = torch.where(masked, hit.t * (1.0 + 1e-4) + 1e-5, tmin)
            hit2 = self.accel.intersect(
                Ray(ray.o, ray.d, tmin, torch.where(masked, ray.tmax, empty), ray.time),
                coherent=coherent)
            hit = Hit(*(torch.where(masked.reshape(masked.shape + (1,) * (a.dim() - 1)), a, b)
                        for a, b in zip(hit2, hit)))
        return hit

    def intersect(self, ray, coherent=False):
        """coherent: the batch is beam-like (camera or shadow rays);
        selects the cheaper frustum cull. Only performance changes."""
        if self.alpha_textures and self.tri_alpha is not None:
            return self._intersect_alpha(ray, coherent=coherent)
        return self.accel.intersect(ray, coherent=coherent)

    def intersect_p(self, ray, coherent=False):
        # alpha scenes: the closest-hit loop, as in the JAX package
        if self.alpha_textures and self.tri_alpha is not None:
            return self._intersect_alpha(ray, coherent=coherent).valid
        return self.accel.intersect_p(ray, coherent=coherent)


def _material_index(mat: Optional[MaterialRecord], materials: List[MaterialRecord],
                    index: Dict[int, int]) -> int:
    if mat is None:
        return -1
    key = id(mat)
    if key not in index:
        index[key] = len(materials)
        materials.append(mat)
    return index[key]


@probes.spanned("scene/compile")
def compile_scene(ro: RenderOptions, device) -> CompiledScene:
    """Lower RenderOptions to device tensors (reference api.cpp:1197)."""
    materials: List[MaterialRecord] = []
    mat_index: Dict[int, int] = {}

    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n, tri_has_n, tri_uv = [], [], []
    tri_mat, tri_light, tri_alpha = [], [], []
    alpha_textures: list = []          # unique alpha textures/constants
    alpha_index: Dict[int, int] = {}   # id(tex) -> row
    quads = []  # (QuadricData, mat, light)
    tri_dv0, tri_de1, tri_de2 = [], [], []   # motion-blur vertex deltas
    quad_o2w_end = []
    any_motion = [False]

    # Area lights get one LightsT row per emitting shape record.
    area_rows = []
    al_v0, al_e1, al_e2, al_area = [], [], [], []

    def add_shape_record(srec: ShapeRecord, extra_xform: Optional[Transform] = None,
                         extra_xform_end: Optional[Transform] = None):
        o2w = srec.o2w if extra_xform is None else (extra_xform * srec.o2w)
        sd = make_shape(srec.kind, srec.params, o2w, o2w.inverse(), srec.reverse_orientation)
        if sd is None:
            return
        # end-of-shutter transform (reference TransformedPrimitive,
        # core/primitive.h:115-117): the shape's and/or the instance's
        # animated CTM
        base_end = srec.animated.end if srec.animated is not None else srec.o2w
        xe = extra_xform_end if extra_xform_end is not None else extra_xform
        o2w_end = base_end if xe is None else (xe * base_end)
        animated = not np.allclose(o2w_end.m, o2w.m, atol=1e-12)
        if animated:
            any_motion[0] = True
        # world delta: v_end = delta @ v_start for the baked vertices
        delta = (o2w_end.m @ np.linalg.inv(o2w.m)).astype(np.float64)
        mi = _material_index(srec.material, materials, mat_index)
        # alpha-texture masking row (reference trianglemesh.cpp:379-437)
        ai = -1
        if srec.alpha_tex is not None:
            key = id(srec.alpha_tex)
            if key not in alpha_index:
                alpha_index[key] = len(alpha_textures)
                alpha_textures.append(srec.alpha_tex)
            ai = alpha_index[key]
        li = -1
        if srec.area_light is not None:
            p = srec.area_light.params
            ones = spec.from_rgb(np.ones(3, np.float32))
            lemit = np.asarray(p.find_one_spectrum("L", ones), np.float32)
            scale = np.asarray(p.find_one_spectrum("scale", ones), np.float32)
            li = len(area_rows)
            area_rows.append({
                "L": lemit * scale, "nsamples": p.find_one_int("nsamples", 1),
                "tri_start": sum(len(a) for a in al_v0), "tri_count": 0,
                "is_sphere": False, "center": np.zeros(3, np.float32), "radius": 0.0,
                "area": 0.0,
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
            if animated:
                v0e, v1e, v2e = (xform_point_affine(delta, v).astype(np.float32)
                                 for v in (v0, v1, v2))
                tri_dv0.append(v0e - v0)
                tri_de1.append((v1e - v0e) - (v1 - v0))
                tri_de2.append((v2e - v0e) - (v2 - v0))
            else:
                for acc in (tri_dv0, tri_de1, tri_de2):
                    acc.append(np.zeros_like(v0))
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
            tri_alpha.append(np.full(len(idx), ai, np.int64))
            if li >= 0:
                e1, e2 = v1 - v0, v2 - v0
                areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
                al_v0.append(v0)
                al_e1.append(e1)
                al_e2.append(e2)
                al_area.append(areas)
                area_rows[li]["tri_count"] += len(idx)
                area_rows[li]["area"] += float(areas.sum())
        for q in sd.quadrics:
            quads.append((q, mi, li))
            quad_o2w_end.append((delta @ q.o2w).astype(np.float32) if animated
                                else np.asarray(q.o2w, np.float32))
            if li < 0:
                continue
            r = float(q.params[0])
            full_sphere = (q.qtype == QUAD_SPHERE and float(q.params[1]) <= -r + 1e-6
                           and float(q.params[2]) >= r - 1e-6
                           and float(q.params[3]) >= 2.0 * np.pi - 1e-5)
            if full_sphere:
                # analytic cone sampling (lights/lighting.py sample_light)
                area_rows[li]["is_sphere"] = True
                area_rows[li]["center"] = np.asarray(q.o2w[:3, 3], np.float32)
                area_rows[li]["radius"] = r
                area_rows[li]["area"] += 4.0 * np.pi * r * r
            else:
                # other quadric emitters are tessellated for light sampling
                # only; intersection stays analytic
                tv0, te1, te2, ta = tessellate_quadric(q)
                al_v0.append(tv0)
                al_e1.append(te1)
                al_e2.append(te2)
                al_area.append(ta)
                area_rows[li]["tri_count"] += len(tv0)
                area_rows[li]["area"] += float(ta.sum())

    for srec in ro.shapes:
        add_shape_record(srec)
    for inst in ro.instances:
        inst_end = inst.animated.end if inst.animated is not None else None
        for srec in inst.shapes:
            add_shape_record(srec, extra_xform=inst.i2w, extra_xform_end=inst_end)

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

    motion = any_motion[0]
    if motion and tri_v0:
        TDV0, TDE1, TDE2 = (np.concatenate(x).astype(np.float32)
                            for x in (tri_dv0, tri_de1, tri_de2))
    else:
        TDV0 = TDE1 = TDE2 = None
    Q_end = np.stack(quad_o2w_end) if (motion and quads) else None
    Q_w2o_end = (np.stack([np.linalg.inv(m.astype(np.float64)).astype(np.float32)
                           for m in quad_o2w_end]) if Q_end is not None else None)

    # world bound over the triangles (at both shutter ends) and each
    # quadric's transformed object-space box corners (conservative)
    pts = [TV0, TV0 + TE1, TV0 + TE2]
    if TDV0 is not None:
        pts += [TV0 + TDV0, TV0 + TDV0 + TE1 + TDE1, TV0 + TDV0 + TE2 + TDE2]
    for qi, (q, _, _) in enumerate(quads):
        r = abs(float(q.params[0]))
        zmin, zmax = float(q.params[1]), float(q.params[2])
        sph = q.qtype == QUAD_SPHERE
        lo = (-r, -r, min(zmin, -r if sph else zmin))
        hi = (r, r, max(zmax, r if sph else zmax))
        corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                            for z in (lo[2], hi[2])])
        pts.append(xform_point_affine(q.o2w, corners).astype(np.float32))
        if motion:
            pts.append(xform_point_affine(quad_o2w_end[qi], corners).astype(np.float32))
    pts = [p for p in pts if len(p)]
    allp = np.concatenate(pts) if pts else np.zeros((1, 3), np.float32)
    world_lo = allp.min(0) - 1e-3
    world_hi = allp.max(0) + 1e-3

    def dev(x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device).contiguous()

    Q_type = np.asarray([q.qtype for q, _, _ in quads], np.int32)
    Q_o2w = (np.stack([q.o2w for q, _, _ in quads]) if quads
             else np.zeros((0, 4, 4), np.float32))
    Q_w2o = (np.stack([q.w2o for q, _, _ in quads]) if quads
             else np.zeros((0, 4, 4), np.float32))
    Q_params = (np.stack([q.params for q, _, _ in quads]) if quads
                else np.zeros((0, 8), np.float32))
    Q_mat = np.asarray([m for _, m, _ in quads], np.int32)
    Q_light = np.asarray([l for _, _, l in quads], np.int32)
    Q_flip = np.asarray([q.reverse_orientation ^ q.swaps_handedness for q, _, _ in quads],
                        bool)
    geom = SceneGeom(
        tri_v0=dev(TV0), tri_e1=dev(TE1), tri_e2=dev(TE2), tri_n=dev(TN),
        tri_has_n=dev(THN), tri_uv=dev(TUV), tri_mat=dev(TM), tri_light=dev(TL),
        world_lo=dev(world_lo, torch.float32), world_hi=dev(world_hi, torch.float32),
        tri_pack=dev(make_tri_pack(TV0, TE1, TE2, TN, TUV, THN, TM, TL, TDV0, TDE1, TDE2)),
        quad_type=dev(Q_type), quad_o2w=dev(Q_o2w), quad_w2o=dev(Q_w2o),
        quad_params=dev(Q_params), quad_mat=dev(Q_mat), quad_light=dev(Q_light),
        quad_flip=dev(Q_flip),
        quad_pack=dev(make_quad_pack(Q_o2w, Q_w2o, Q_params, Q_type, Q_flip, Q_mat, Q_light,
                                     Q_end, Q_w2o_end)),
        quad_present=frozenset(int(k) for k in Q_type),
        tri_dv0=None if TDV0 is None else dev(TDV0),
        tri_de1=None if TDE1 is None else dev(TDE1),
        tri_de2=None if TDE2 is None else dev(TDE2),
        quad_o2w_end=None if Q_end is None else dev(Q_end),
        quad_w2o_end=None if Q_w2o_end is None else dev(Q_w2o_end),
        time0=float(ro.transform_start_time), time1=float(ro.transform_end_time),
    )
    lights, light_dist = _build_lights(ro, area_rows, al_v0, al_e1, al_e2, al_area,
                                       world_lo, world_hi, device)
    volume = build_volumes(ro.volume_regions, device)
    disp = np.asarray([m.dispersive() for m in materials], bool)
    info(f"compiled scene: {len(TV0)} tris, {len(quads)} quadrics, "
         f"{0 if lights is None else int(lights.kind.shape[0])} lights, "
         f"{len(materials)} materials")

    accel_name = ro.accelerator_name
    split = ro.accelerator_params.find_one_string("splitmethod", "sah")
    if accel_name not in ("bvh", "grid", "kdtree", "none"):
        warning(f'Accelerator "{accel_name}" unknown; using "bvh".')
        accel_name = "bvh"
    if accel_name == "grid":
        from pbrt_tpu_torch.accel.grid import make_grid_accel

        accel = make_grid_accel(geom)
    elif accel_name == "kdtree":
        from pbrt_tpu_torch.accel.kdtree import make_kdtree_accel

        accel = make_kdtree_accel(geom, ro.accelerator_params)
    else:
        from pbrt_tpu_torch.accel.bvh import make_accel

        accel = make_accel(geom, split, force="flat" if accel_name == "none" else "")
    # stack the measured half-angle BRDF tables (materials/measured.py);
    # each measured material gets a row of the [T,TH,TD,PD,3] stack
    merl = [m for m in materials if m.kind == "measured" and "merl" in m.spectra]
    meas_index = {id(m): i for i, m in enumerate(merl)}
    meas_tables = dev(np.stack([m.spectra["merl"] for m in merl])) if merl else None
    return CompiledScene(geom=geom, lights=lights, light_dist=light_dist,
                         materials=materials, material_dispersive=dev(disp),
                         world_lo=world_lo, world_hi=world_hi, accel=accel, volume=volume,
                         meas_tables=meas_tables, meas_index=meas_index,
                         alpha_textures=alpha_textures,
                         tri_alpha=(dev(np.concatenate(tri_alpha))
                                    if alpha_textures and tri_alpha else None))


def _build_lights(ro: RenderOptions, area_rows, al_v0, al_e1, al_e2, al_area,
                  world_lo, world_hi, device):
    """Lower light records + collected area-light rows to LightsT."""
    kinds, l2w, spectra, params, power, nsamples = [], [], [], [], [], []
    world_c = 0.5 * (world_lo + world_hi)
    world_rad = float(np.linalg.norm(world_hi - world_c)) + 1e-3

    env_specs = []  # (row index, rgb image, kind)

    def add(kind, xform: Transform, spectrum, pr, pw, ns=1):
        kinds.append(kind)
        l2w.append(xform.m.astype(np.float32))
        spectra.append(np.asarray(spectrum, np.float32))
        p12 = np.zeros(12, np.float32)
        p12[: len(pr)] = pr
        params.append(p12)
        power.append(np.asarray(pw, np.float32))
        nsamples.append(ns)
        return len(kinds) - 1

    for rec in ro.lights:
        p = rec.params
        name = rec.kind
        if name not in ("point", "spot", "goniometric", "projection", "distant", "infinite",
                        "exinfinite"):
            warning(f'Light "{name}" unknown.')
            continue
        ns = p.find_one_int("nsamples", 1)
        ones = spec.from_rgb(np.ones(3, np.float32))
        sc = np.asarray(p.find_one_spectrum("scale", ones), np.float32)
        if name == "point":
            I = np.asarray(p.find_one_spectrum("I", ones), np.float32) * sc
            frm = np.asarray(p.find_one_point("from", [0, 0, 0]), np.float64)
            add(L_POINT, rec.l2w * Transform.translate(frm), I, [], 4.0 * np.pi * I, ns)
        elif name == "spot":
            I = np.asarray(p.find_one_spectrum("I", ones), np.float32) * sc
            cone = p.find_one_float("coneangle", 30.0)
            delta = p.find_one_float("conedeltaangle", 5.0)
            frm = np.asarray(p.find_one_point("from", [0, 0, 0]), np.float64)
            to = np.asarray(p.find_one_point("to", [0, 0, 1]), np.float64)
            d = to - frm
            dn = d / max(np.linalg.norm(d), 1e-12)
            # light-to-world with +z along the beam (reference spot.cpp)
            du = np.array([0.0, 1.0, 0.0]) if abs(dn[2]) > 0.9 else np.array([0.0, 0.0, 1.0])
            x = np.cross(du, dn)
            x /= max(np.linalg.norm(x), 1e-12)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, np.cross(dn, x), dn, frm
            cw = np.cos(np.deg2rad(cone))
            cf = np.cos(np.deg2rad(cone - delta))
            add(L_SPOT, rec.l2w * Transform(m), I, [cw, cf],
                I * 2.0 * np.pi * (1.0 - 0.5 * (cw + cf)), ns)
        elif name == "goniometric":
            I = np.asarray(p.find_one_spectrum("I", ones), np.float32) * sc
            img = _load_light_image(p.find_one_filename("mapname", ""))
            row = add(L_GONIO, rec.l2w, I, [], 4.0 * np.pi * I * (img[1] if img else 1.0), ns)
            if img is not None:
                env_specs.append((row, img[0], L_GONIO))
        elif name == "projection":
            I = np.asarray(p.find_one_spectrum("I", ones), np.float32) * sc
            fov = p.find_one_float("fov", 45.0)
            img = _load_light_image(p.find_one_filename("mapname", ""))
            aspect = (img[0].shape[1] / img[0].shape[0]) if img else 1.0
            t = np.tan(np.deg2rad(fov) / 2.0)
            if aspect > 1.0:
                x0, x1, y0, y1 = -t * aspect, t * aspect, -t, t
            else:
                x0, x1, y0, y1 = -t, t, -t / aspect, t / aspect
            cw = np.cos(np.arctan(t * np.hypot(1.0, 1.0 / (1.0 if aspect <= 1 else aspect))))
            row = add(L_PROJECTION, rec.l2w, I, [cw, x0, x1, y0, y1, 1e-3],
                      2.0 * np.pi * (1.0 - cw) * I, ns)
            if img is not None:
                env_specs.append((row, img[0], L_PROJECTION))
        elif name == "distant":
            L = np.asarray(p.find_one_spectrum("L", ones), np.float32) * sc
            frm = np.asarray(p.find_one_point("from", [0, 0, 0]), np.float64)
            to = np.asarray(p.find_one_point("to", [0, 0, 1]), np.float64)
            d = frm - to   # toward the light
            dn = rec.l2w.vector(d / max(np.linalg.norm(d), 1e-12))
            add(L_DISTANT, Transform(), L, list(np.asarray(dn, np.float64)),
                L * np.pi * world_rad * world_rad, ns)
        else:  # infinite / exinfinite
            L = np.asarray(p.find_one_spectrum("L", ones), np.float32) * sc
            img = _load_light_image(p.find_one_filename("mapname", ""))
            row = add(L_INFINITE, rec.l2w, L, [],
                      np.pi * world_rad * world_rad * L * (img[1] if img else 1.0), ns)
            env_specs.append((row, img[0] if img else np.ones((1, 1, 3), np.float32),
                              L_INFINITE))
        p.report_unused(f'in light "{name}"')

    for row in area_rows:
        pr = [row["area"], 1.0 if row["is_sphere"] else 0.0,
              row["center"][0], row["center"][1], row["center"][2], row["radius"],
              row["tri_start"], row["tri_count"]]
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

    envs = []
    for row, img, kind in env_specs:
        img_spec = spec.from_rgb(img.astype(np.float32))
        # importance: luminance * sin(theta) over the rows (reference infinite.cpp:85)
        h = img.shape[0]
        sin_t = np.sin(np.pi * (np.arange(h) + 0.5) / h)
        envs.append(EnvMap(light_idx=row, kind=kind, image=dev(np.asarray(img_spec, np.float32)),
                           dist=Distribution2D.make(spec.y(img_spec) * sin_t[:, None], device)))

    L2W = np.stack(l2w)
    lights = LightsT(
        kind=dev(kinds, torch.int32), l2w=dev(L2W),
        w2l=dev(np.stack([np.linalg.inv(m) for m in L2W]).astype(np.float32)),
        spectra=dev(np.stack(spectra)), params=dev(np.stack(params)),
        power=dev(np.stack(power)), n_samples=dev(nsamples, torch.int32),
        al_v0=dev(AV0), al_e1=dev(AE1), al_e2=dev(AE2), al_cdf=dev(ACDF),
        envs=tuple(envs),
    )
    # power-weighted light pick CDF (reference core/integrator.h:110)
    pw = np.stack([np.asarray(spec.y(np.asarray(p))) for p in power]).reshape(len(power))
    pw = np.maximum(pw, 1e-9)
    return lights, Distribution1D.make(dev(pw, torch.float32))


def _load_light_image(fn: str):
    """-> (rgb [h, w, 3] float array, mean luminance) or None (with a
    warning when the file cannot be read)."""
    if not fn:
        return None
    from pbrt_tpu_torch.io.image import read_image

    try:
        img = read_image(fn)
    except Exception as e:  # a missing map: warn, light without it
        warning(f'Unable to read image "{fn}": {e}')
        return None
    mean = float(np.mean(0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]))
    return img, mean




# ---------------------------------------------------------------------------
# Shading-time material evaluation

_SCALAR_SLOTS = ("rough_u", "rough_v", "eta", "vn", "sigma")


def _merge(sel, p: BsdfParams, old: BsdfParams) -> BsdfParams:
    """Lanes `sel` take p's slots, the others keep old's (mix children
    and amount included)."""
    merged = old._replace(
        kind=torch.where(sel, p.kind, old.kind),
        **{f: torch.where(sel[:, None], getattr(p, f), getattr(old, f))
           for f in ("kd", "ks", "kr", "kt", "opacity")},
        **{f: torch.where(sel, getattr(p, f), getattr(old, f)) for f in _SCALAR_SLOTS})
    if old.mix2 is not None:
        merged = merged._replace(mix2=_merge(sel, p.mix2, old.mix2),
                                 mix_amt=torch.where(sel[:, None], p.mix_amt, old.mix_amt))
    return merged


def eval_bsdf_params(scene: CompiledScene, hit) -> BsdfParams:
    """Per-hit BsdfParams from the unique-material list, masked select.
    Texture graphs are evaluated over the whole batch at the hits'
    (p, uv), with zero differentials (ShadingGeom.at)."""
    H = hit.p.shape[0]
    dev = hit.p.device
    sg = ShadingGeom.at(hit.p, hit.uv)
    out = BsdfParams.none(H, dev)
    has_mix = any(m.kind == "mix" for m in scene.materials)
    if has_mix:
        out = out._replace(mix2=BsdfParams.none(H, dev), mix_amt=torch.ones((H, S), device=dev))
    meas_id = torch.full((H,), -1, dtype=torch.int64, device=dev)
    for mi, mat in enumerate(scene.materials):
        sel = hit.mat == mi
        p = _lower_material(mat, sg, H)
        if scene.kd_scale is not None:
            # the differentiable albedo (diff.py): gradients with respect
            # to a material's diffuse albedo flow through this product
            p = p._replace(kd=p.kd * scene.kd_scale[mi])
        if has_mix and p.mix2 is None:
            # non-mix materials in a mix scene: amount 1 routes all the
            # weight to the first constituent
            p = p._replace(mix2=BsdfParams.none(H, dev), mix_amt=torch.ones((H, S), device=dev))
        out = _merge(sel, p, out)
        if id(mat) in scene.meas_index:
            meas_id = torch.where(sel, torch.full((), scene.meas_index[id(mat)],
                                                  dtype=torch.int64, device=dev), meas_id)
    if scene.meas_tables is not None:
        out = out._replace(meas_id=meas_id, meas_tables=scene.meas_tables)
    return out


def _tex_spec(mat, name, sg, H, default=0.0):
    tex = mat.textures.get(name)
    if tex is None:
        return torch.full((H, S), default, device=sg.p.device)
    v = tex.eval(sg).to(torch.float32)
    if v.dim() == 1:       # a float texture (or scalar constant) in a spectral slot
        v = v[:, None]
    return v.expand(H, S)


def _tex_float(mat, name, sg, H, default=0.0):
    tex = mat.textures.get(name)
    if tex is None:
        return torch.full((H,), default, device=sg.p.device)
    return tex.eval(sg).to(torch.float32).expand(H)


def _lower_material(mat: MaterialRecord, sg: ShadingGeom, H: int) -> BsdfParams:
    """One material record -> full BsdfParams slots (see bsdf.material_lobes
    for the slot-per-kind conventions)."""
    kind = mat.kind
    dev = sg.p.device
    zs = torch.zeros((H, S), device=dev)
    zf = torch.zeros((H,), device=dev)
    kd = ks = kr = kt = zs
    opacity = torch.ones((H, S), device=dev)
    rough_u = rough_v = zf
    eta = torch.full((H,), 1.5, device=dev)
    vn = sigma = zf

    def const_spec(name):
        # copied to the card once per material and device, not per call
        cache = mat.__dict__.setdefault("_dev_spectra", {})
        if (name, dev) not in cache:
            cache[(name, dev)] = torch.as_tensor(mat.spectra[name], device=dev)
        return cache[(name, dev)].expand(H, S)

    if kind == "matte":
        kd = _tex_spec(mat, "Kd", sg, H, 0.5)
        sigma = _tex_float(mat, "sigma", sg, H, 0.0)
    elif kind == "plastic":
        kd = _tex_spec(mat, "Kd", sg, H, 0.25)
        ks = _tex_spec(mat, "Ks", sg, H, 0.25)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
    elif kind == "translucent":
        kd = _tex_spec(mat, "Kd", sg, H, 0.25)
        ks = _tex_spec(mat, "Ks", sg, H, 0.25)
        kr = _tex_spec(mat, "reflect", sg, H, 0.5)
        kt = _tex_spec(mat, "transmit", sg, H, 0.5)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
    elif kind == "glass":
        kr = _tex_spec(mat, "Kr", sg, H, 1.0)
        kt = _tex_spec(mat, "Kt", sg, H, 1.0)
        eta = _tex_float(mat, "index", sg, H, 1.5)
        vn = torch.full((H,), mat.consts.get("Vn", 0.0), device=dev)
    elif kind == "mirror":
        kr = _tex_spec(mat, "Kr", sg, H, 0.9)
    elif kind == "metal":
        kd = const_spec("eta")
        ks = const_spec("k")
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.01)
    elif kind == "substrate":
        kd = _tex_spec(mat, "Kd", sg, H, 0.5)
        ks = _tex_spec(mat, "Ks", sg, H, 0.5)
        rough_u = _tex_float(mat, "uroughness", sg, H, 0.1)
        rough_v = _tex_float(mat, "vroughness", sg, H, 0.1)
    elif kind == "uber":
        kd = _tex_spec(mat, "Kd", sg, H, 0.25)
        ks = _tex_spec(mat, "Ks", sg, H, 0.25)
        kr = _tex_spec(mat, "Kr", sg, H, 0.0)
        kt = _tex_spec(mat, "Kt", sg, H, 0.0)
        opacity = _tex_spec(mat, "opacity", sg, H, 1.0)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
        eta = _tex_float(mat, "index", sg, H, 1.5)
    elif kind == "shinymetal":
        ks = _tex_spec(mat, "Ks", sg, H, 1.0)
        kr = _tex_spec(mat, "Kr", sg, H, 1.0)
        rough_u = rough_v = _tex_float(mat, "roughness", sg, H, 0.1)
    elif kind == "measured":
        kd = const_spec("albedo")
    elif kind in ("subsurface", "kdsubsurface"):
        kr = _tex_spec(mat, "Kr", sg, H, 1.0)
        eta = torch.full((H,), mat.consts.get("index", 1.3), device=dev)
    elif kind == "mix":
        # two-constituent mix (reference materials/mixmat.cpp:62): both
        # children lowered to full slot sets, blended by the spectral
        # amount in materials/bsdf.py. Nested mixes flatten to their
        # first constituent, as in the JAX package.
        m1, m2 = mat.children
        if any(getattr(c, "kind", None) == "mix" for c in (m1, m2)):
            warning("nested mix materials flatten to their first "
                    "constituent (mix(mix(a,b),c) renders as mix(a,c)); "
                    "the reference recursively concatenates ScaledBxDFs")
        amt = _tex_spec(mat, "amount", sg, H, 0.5)
        p1 = _lower_material(m1, sg, H)
        p2 = _lower_material(m2, sg, H)._replace(mix2=None, mix_amt=None)
        return p1._replace(mix2=p2, mix_amt=torch.clamp(amt, 0.0, 1.0))

    kid = KIND_ID.get(kind, KIND_ID["matte"])
    return BsdfParams(kind=torch.full((H,), kid, dtype=torch.int64, device=dev),
                      kd=kd, ks=ks, kr=kr, kt=kt, opacity=opacity, rough_u=rough_u,
                      rough_v=rough_v, eta=eta, vn=vn, sigma=sigma)


def eval_bump(scene: CompiledScene, hit: Hit, frame):
    """Bump-mapped shading frame (reference core/material.cpp Bump):
    displace p along dpdu/dpdv by the bump texture's finite differences
    and rebuild ns. No-op when no material carries a bumpmap."""
    bumped = [(mi, m.textures["bumpmap"]) for mi, m in enumerate(scene.materials)
              if m.textures.get("bumpmap") is not None]
    if not bumped:
        return frame
    H = hit.p.shape[0]
    du = 0.5 * (torch.abs(hit.uv[:, 0]) + 1e-3)
    dv = 0.5 * (torch.abs(hit.uv[:, 1]) + 1e-3)
    dpdv = cross(hit.ns, hit.dpdu)
    zero = torch.zeros_like(du)
    sg0 = ShadingGeom.at(hit.p, hit.uv)
    sgu = ShadingGeom.at(hit.p + du[:, None] * hit.dpdu, hit.uv + torch.stack([du, zero], -1))
    sgv = ShadingGeom.at(hit.p + dv[:, None] * dpdv, hit.uv + torch.stack([zero, dv], -1))
    disp = disp_u = disp_v = torch.zeros((H,), device=hit.p.device)
    for mi, tex in bumped:
        sel = hit.mat == mi
        disp = torch.where(sel, tex.eval(sg0).to(torch.float32).expand(H), disp)
        disp_u = torch.where(sel, tex.eval(sgu).to(torch.float32).expand(H), disp_u)
        disp_v = torch.where(sel, tex.eval(sgv).to(torch.float32).expand(H), disp_v)
    dddu = (disp_u - disp) / torch.clamp(du, min=1e-6)
    dddv = (disp_v - disp) / torch.clamp(dv, min=1e-6)
    dpdu_b = hit.dpdu + dddu[:, None] * hit.ns
    dpdv_b = dpdv + dddv[:, None] * hit.ns
    ns = normalize(cross(dpdu_b, dpdv_b))
    # keep the orientation of the original shading normal
    ns = torch.where((torch.sum(ns * hit.ns, -1) < 0)[:, None], -ns, ns)
    ss = normalize(dpdu_b - ns * torch.sum(dpdu_b * ns, -1, keepdim=True))
    return frame._replace(ss=ss, ts=cross(ns, ss), ns=ns)
