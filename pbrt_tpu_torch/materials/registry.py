"""Material factory: plugin name + TextureParams -> MaterialRecord.

Port of pbrt_tpu/materials/registry.py (host code, carried over; the
"measured" kind needs the BRDF loader, which is not yet ported).

Replaces reference core/api.cpp:364-415 MakeMaterial dispatch and each
materials/*.cpp CreateMaterial factory, preserving parameter names and
defaults (see SURVEY.md section 2.2 Materials). The records are lowered
to the closed-set BSDF tables in pbrt_tpu_torch.materials.bsdf.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import PbrtError, warning
from pbrt_tpu_torch.scene.records import MaterialRecord

# copper n/k sampled spectra for "metal" defaults (reference
# materials/metal.cpp uses measured copper SPDs). Values from the public
# CRC/Palik copper optical constants, coarsely sampled 400-700nm.
_CU_LAMBDA = [400, 450, 500, 550, 600, 650, 700]
_CU_N = [1.175, 1.150, 1.130, 0.870, 0.370, 0.240, 0.213]
_CU_K = [2.210, 2.400, 2.600, 2.580, 3.010, 3.400, 3.800]
COPPER_N = spec.from_sampled(_CU_LAMBDA, _CU_N)
COPPER_K = spec.from_sampled(_CU_LAMBDA, _CU_K)

MATERIAL_KINDS = [
    "none", "matte", "plastic", "translucent", "glass", "mirror", "metal",
    "substrate", "uber", "shinymetal", "measured", "subsurface",
    "kdsubsurface", "mix",
]
KIND_ID = {k: i for i, k in enumerate(MATERIAL_KINDS)}


def make_material(name: str, tp, named_materials: Dict[str, MaterialRecord]) -> Optional[MaterialRecord]:
    if name == "" or name == "none":
        return None
    rec = MaterialRecord(kind=name)
    t = rec.textures
    c = rec.consts
    if name == "matte":
        t["Kd"] = tp.get_spectrum_texture("Kd", np.float32(0.5))
        t["sigma"] = tp.get_float_texture("sigma", 0.0)
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "plastic":
        t["Kd"] = tp.get_spectrum_texture("Kd", np.float32(0.25))
        t["Ks"] = tp.get_spectrum_texture("Ks", np.float32(0.25))
        t["roughness"] = tp.get_float_texture("roughness", 0.1)
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "translucent":
        t["Kd"] = tp.get_spectrum_texture("Kd", np.float32(0.25))
        t["Ks"] = tp.get_spectrum_texture("Ks", np.float32(0.25))
        t["roughness"] = tp.get_float_texture("roughness", 0.1)
        t["reflect"] = tp.get_spectrum_texture("reflect", np.float32(0.5))
        t["transmit"] = tp.get_spectrum_texture("transmit", np.float32(0.5))
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "glass":
        # reference materials/glass.cpp:64-69 (+ student Vn for dispersion)
        t["Kr"] = tp.get_spectrum_texture("Kr", np.float32(1.0))
        t["Kt"] = tp.get_spectrum_texture("Kt", np.float32(1.0))
        t["index"] = tp.get_float_texture("index", 1.5)
        c["Vn"] = tp.find_float("Vn", 0.0)
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "mirror":
        t["Kr"] = tp.get_spectrum_texture("Kr", np.float32(0.9))
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "metal":
        rec.spectra["eta"] = np.asarray(tp.find_spectrum("eta", COPPER_N), np.float32)
        rec.spectra["k"] = np.asarray(tp.find_spectrum("k", COPPER_K), np.float32)
        t["roughness"] = tp.get_float_texture("roughness", 0.01)
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "substrate":
        t["Kd"] = tp.get_spectrum_texture("Kd", np.float32(0.5))
        t["Ks"] = tp.get_spectrum_texture("Ks", np.float32(0.5))
        t["uroughness"] = tp.get_float_texture("uroughness", 0.1)
        t["vroughness"] = tp.get_float_texture("vroughness", 0.1)
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "uber":
        t["Kd"] = tp.get_spectrum_texture("Kd", np.float32(0.25))
        t["Ks"] = tp.get_spectrum_texture("Ks", np.float32(0.25))
        t["Kr"] = tp.get_spectrum_texture("Kr", np.float32(0.0))
        t["Kt"] = tp.get_spectrum_texture("Kt", np.float32(0.0))
        t["roughness"] = tp.get_float_texture("roughness", 0.1)
        t["opacity"] = tp.get_spectrum_texture("opacity", np.float32(1.0))
        t["index"] = tp.get_float_texture("index", 1.5)
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "shinymetal":
        t["Ks"] = tp.get_spectrum_texture("Ks", np.float32(1.0))
        t["Kr"] = tp.get_spectrum_texture("Kr", np.float32(1.0))
        t["roughness"] = tp.get_float_texture("roughness", 0.1)
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    elif name == "mix":
        m1name = tp.find_string("namedmaterial1", "")
        m2name = tp.find_string("namedmaterial2", "")
        m1 = named_materials.get(m1name)
        m2 = named_materials.get(m2name)
        if m1 is None or m2 is None:
            warning(f'Named materials "{m1name}"/"{m2name}" for mix not found; using matte')
            return make_material("matte", tp, named_materials)
        t["amount"] = tp.get_spectrum_texture("amount", np.float32(0.5))
        rec.children = (m1, m2)
    elif name == "measured":
        raise PbrtError('not yet ported: material "measured"')
    elif name in ("subsurface", "kdsubsurface"):
        # BSSRDF materials: record scattering properties; surface BSDF is a
        # fresnel-weighted specular (reference materials/subsurface.cpp).
        if name == "subsurface":
            sa = tp.find_spectrum("sigma_a", np.asarray(spec.from_rgb(np.array([0.0011, 0.0024, 0.014], np.float32)) , np.float32))
            sps = tp.find_spectrum("sigma_prime_s", np.asarray(spec.from_rgb(np.array([2.55, 3.21, 3.77], np.float32)), np.float32))
            nm = tp.find_string("name", "")
            if nm:
                props = _named_scattering_properties(nm)
                if props is not None:
                    sa, sps = props
            sc = tp.find_float("scale", 1.0)
            rec.spectra["sigma_a"] = np.asarray(sa, np.float32) * sc
            rec.spectra["sigma_prime_s"] = np.asarray(sps, np.float32) * sc
        else:
            t["Kd"] = tp.get_spectrum_texture("Kd", np.float32(0.5))
            c["meanfreepath"] = tp.find_float("meanfreepath", 1.0)
        t["Kr"] = tp.get_spectrum_texture("Kr", np.float32(1.0))
        c["index"] = tp.find_float("eta", tp.find_float("index", 1.3))
        t["bumpmap"] = tp.get_float_texture_or_none("bumpmap")
    else:
        warning(f'Material "{name}" unknown. Using "matte".')
        return make_material("matte", tp, named_materials)
    tp.report_unused(f'in material "{name}"')
    return rec


# Jensen et al. 2001 measured media (subset; reference core/volume.cpp
# GetVolumeScatteringProperties table). sigma_prime_s / sigma_a in mm^-1.
_NAMED_MEDIA = {
    "Apple": ([2.29, 2.39, 1.97], [0.0030, 0.0034, 0.046]),
    "Chicken1": ([0.15, 0.21, 0.38], [0.015, 0.077, 0.19]),
    "Chicken2": ([0.19, 0.25, 0.32], [0.018, 0.088, 0.20]),
    "Cream": ([7.38, 5.47, 3.15], [0.0002, 0.0028, 0.0163]),
    "Ketchup": ([0.18, 0.07, 0.03], [0.061, 0.97, 1.45]),
    "Marble": ([2.19, 2.62, 3.00], [0.0021, 0.0041, 0.0071]),
    "Potato": ([0.68, 0.70, 0.55], [0.0024, 0.0090, 0.12]),
    "Skimmilk": ([0.70, 1.22, 1.90], [0.0014, 0.0025, 0.0142]),
    "Skin1": ([0.74, 0.88, 1.01], [0.032, 0.17, 0.48]),
    "Skin2": ([1.09, 1.59, 1.79], [0.013, 0.070, 0.145]),
    "Spectralon": ([11.6, 20.4, 14.9], [0.00, 0.00, 0.00]),
    "Wholemilk": ([2.55, 3.21, 3.77], [0.0011, 0.0024, 0.014]),
}


def _named_scattering_properties(name: str):
    ent = _NAMED_MEDIA.get(name)
    if ent is None:
        warning(f'Scattering properties for medium "{name}" not found')
        return None
    sps, sa = ent
    return (
        np.asarray(spec.from_rgb(np.asarray(sa, np.float32)), np.float32),
        np.asarray(spec.from_rgb(np.asarray(sps, np.float32)), np.float32),
    )
