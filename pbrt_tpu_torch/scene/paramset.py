"""Typed parameter sets for the .pbrt scene language.

Host-side replacement for reference core/paramset.{h,cpp}: a name ->
typed-array store with FindOne*/Find getters carrying defaults, unused-
parameter reporting, and the two-level geometry->material TextureParams
lookup. Values are plain NumPy/python (scene build happens on host; the
scene compiler turns the result into device tensors).

Spectrum parameters may be declared as "rgb"/"color", "xyz",
"blackbody", "spectrum" (inline samples or .spd file) and are all
normalized here to 30-bin arrays (pbrt_tpu_torch.core.spectrum).
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import warning

PARAM_TYPES = (
    "integer", "float", "bool", "point", "vector", "normal",
    "rgb", "color", "xyz", "blackbody", "spectrum", "string", "texture",
)


def _read_float_file(path: str) -> List[float]:
    """Whitespace/#-comment float file (reference core/floatfile.cpp)."""
    vals: List[float] = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0]
            vals.extend(float(tok) for tok in line.split())
    return vals


class ParamSet:
    """name -> (decl_type, values). Tracks which params were looked up."""

    def __init__(self, search_dir: str = "."):
        self.items: Dict[str, Tuple[str, Any]] = {}
        self.used: set = set()
        self.search_dir = search_dir

    # -- construction --

    def add(self, decl_type: str, name: str, values):
        t = decl_type
        if t == "color":
            t = "rgb"
        if t == "integer":
            values = np.asarray([int(v) for v in values], np.int32)
        elif t == "float":
            values = np.asarray(values, np.float32)
        elif t == "bool":
            values = np.asarray(
                [v if isinstance(v, bool) else str(v).lower() == "true" for v in values]
            )
        elif t in ("point", "vector", "normal"):
            values = np.asarray(values, np.float32).reshape(-1, 3)
        elif t == "rgb":
            rgb = np.asarray(values, np.float32).reshape(-1, 3)
            values = spec.from_rgb(rgb)
        elif t == "xyz":
            xyz = np.asarray(values, np.float32).reshape(-1, 3)
            values = spec.from_rgb(xyz @ spec.XYZ_TO_RGB.T)
        elif t == "blackbody":
            # pairs (temperature, scale)
            arr = np.asarray(values, np.float32).reshape(-1, 2)
            values = np.stack([spec.blackbody(t_) * s for t_, s in arr])
        elif t == "spectrum":
            if len(values) and isinstance(values[0], str):
                spectra = []
                for fn in values:
                    path = fn if os.path.isabs(fn) else os.path.join(self.search_dir, fn)
                    raw = _read_float_file(path)
                    lam, v = raw[0::2], raw[1::2]
                    spectra.append(spec.from_sampled(lam, v))
                values = np.stack(spectra)
            else:
                arr = np.asarray(values, np.float32).reshape(-1)
                lam, v = arr[0::2], arr[1::2]
                values = spec.from_sampled(lam, v)[None]
        elif t in ("string", "texture"):
            values = [str(v) for v in values]
        else:
            raise ValueError(f"unknown parameter type {decl_type!r}")
        self.items[name] = (t, values)

    # -- lookup --

    def _get(self, name: str, want_types: Tuple[str, ...]):
        ent = self.items.get(name)
        if ent is None or ent[0] not in want_types:
            return None
        self.used.add(name)
        return ent[1]

    def find_one_float(self, name, default):
        v = self._get(name, ("float", "integer"))
        return float(v[0]) if v is not None and len(v) else float(default)

    def find_one_int(self, name, default):
        v = self._get(name, ("integer", "float"))
        return int(v[0]) if v is not None and len(v) else int(default)

    def find_one_bool(self, name, default):
        v = self._get(name, ("bool",))
        return bool(v[0]) if v is not None and len(v) else bool(default)

    def find_one_point(self, name, default):
        v = self._get(name, ("point",))
        return np.asarray(v[0] if v is not None and len(v) else default, np.float32)

    def find_one_vector(self, name, default):
        v = self._get(name, ("vector",))
        return np.asarray(v[0] if v is not None and len(v) else default, np.float32)

    def find_one_normal(self, name, default):
        v = self._get(name, ("normal",))
        return np.asarray(v[0] if v is not None and len(v) else default, np.float32)

    def find_one_spectrum(self, name, default):
        v = self._get(name, ("rgb", "xyz", "blackbody", "spectrum"))
        if v is not None and len(v):
            return np.asarray(v[0], np.float32)
        if np.isscalar(default):
            return np.full(spec.N_BINS, default, np.float32)
        d = np.asarray(default, np.float32)
        if d.shape == (3,):
            return np.asarray(spec.from_rgb(d), np.float32)
        return d

    def find_one_string(self, name, default):
        v = self._get(name, ("string",))
        return str(v[0]) if v is not None and len(v) else str(default)

    def find_one_filename(self, name, default=""):
        s = self.find_one_string(name, default)
        if not s:
            return s
        return s if os.path.isabs(s) else os.path.join(self.search_dir, s)

    def find_texture(self, name):
        v = self._get(name, ("texture",))
        return str(v[0]) if v is not None and len(v) else ""

    def find_float(self, name):
        v = self._get(name, ("float",))
        return None if v is None else np.asarray(v, np.float32)

    def find_int(self, name):
        v = self._get(name, ("integer",))
        return None if v is None else np.asarray(v, np.int32)

    def find_point(self, name):
        v = self._get(name, ("point",))
        return None if v is None else np.asarray(v, np.float32).reshape(-1, 3)

    def find_vector(self, name):
        v = self._get(name, ("vector",))
        return None if v is None else np.asarray(v, np.float32).reshape(-1, 3)

    def find_normal(self, name):
        v = self._get(name, ("normal",))
        return None if v is None else np.asarray(v, np.float32).reshape(-1, 3)

    def find_string(self, name):
        v = self._get(name, ("string",))
        return None if v is None else list(v)

    def find_bool(self, name):
        v = self._get(name, ("bool",))
        return None if v is None else np.asarray(v, bool)

    def find_spectrum(self, name):
        v = self._get(name, ("rgb", "xyz", "blackbody", "spectrum"))
        return None if v is None else np.asarray(v, np.float32)

    def report_unused(self, where: str = ""):
        for name in self.items:
            if name not in self.used:
                warning(f'Parameter "{name}" not used {where}')

    def __contains__(self, name):
        return name in self.items

    def __repr__(self):
        return f"ParamSet({ {k: v[0] for k, v in self.items.items()} })"


class TextureParams:
    """Two-level lookup: geometry params shadow material params
    (reference core/paramset.h:160-178). Also resolves texture-typed
    params against the named float/spectrum texture dictionaries."""

    def __init__(self, geom: ParamSet, material: ParamSet, float_textures, spectrum_textures):
        self.geom = geom
        self.material = material
        self.float_textures = float_textures
        self.spectrum_textures = spectrum_textures

    def find_float(self, name, default):
        return self.geom.find_one_float(name, self.material.find_one_float(name, default))

    def find_string(self, name, default=""):
        return self.geom.find_one_string(name, self.material.find_one_string(name, default))

    def find_filename(self, name, default=""):
        g = self.geom.find_one_filename(name, "")
        return g if g else self.material.find_one_filename(name, default)

    def find_int(self, name, default):
        return self.geom.find_one_int(name, self.material.find_one_int(name, default))

    def find_bool(self, name, default):
        return self.geom.find_one_bool(name, self.material.find_one_bool(name, default))

    def find_point(self, name, default):
        return self.geom.find_one_point(name, self.material.find_one_point(name, default))

    def find_vector(self, name, default):
        return self.geom.find_one_vector(name, self.material.find_one_vector(name, default))

    def find_normal(self, name, default):
        return self.geom.find_one_normal(name, self.material.find_one_normal(name, default))

    def find_spectrum(self, name, default):
        return self.geom.find_one_spectrum(name, self.material.find_one_spectrum(name, default))

    def get_spectrum_texture(self, name, default):
        """-> texture descriptor: ("named", tex) | ("constant", spectrum)."""
        tex_name = self.geom.find_texture(name) or self.material.find_texture(name)
        if tex_name:
            if tex_name in self.spectrum_textures:
                return self.spectrum_textures[tex_name]
            warning(f'Couldn\'t find spectrum texture named "{tex_name}" for parameter "{name}"')
        sv = self.geom.find_spectrum(name)
        if sv is None:
            sv = self.material.find_spectrum(name)
        if sv is not None:
            val = sv[0] if sv.ndim > 1 else sv
        else:
            # accept a float param where a spectrum is expected (e.g.
            # `"float amount" [.4]` on a mix material): grey spectrum
            fv = self.geom._get(name, ("float", "integer"))
            if fv is None:
                fv = self.material._get(name, ("float", "integer"))
            val = float(fv[0]) if fv is not None and len(fv) else default
        val = np.asarray(val, np.float32)
        if val.ndim == 0:
            val = np.full(spec.N_BINS, float(val), np.float32)
        elif val.shape == (3,):
            val = np.asarray(spec.from_rgb(val), np.float32)
        from pbrt_tpu_torch.textures.registry import ConstantTexture

        return ConstantTexture(val)

    def get_float_texture(self, name, default):
        tex_name = self.geom.find_texture(name) or self.material.find_texture(name)
        if tex_name:
            if tex_name in self.float_textures:
                return self.float_textures[tex_name]
            warning(f'Couldn\'t find float texture named "{tex_name}" for parameter "{name}"')
        val = self.find_float(name, default)
        from pbrt_tpu_torch.textures.registry import ConstantTexture

        return ConstantTexture(np.float32(val))

    def get_float_texture_or_none(self, name):
        tex_name = self.geom.find_texture(name) or self.material.find_texture(name)
        if tex_name and tex_name in self.float_textures:
            return self.float_textures[tex_name]
        v = self.geom.find_float(name)
        if v is None:
            v = self.material.find_float(name)
        if v is None:
            return None
        from pbrt_tpu_torch.textures.registry import ConstantTexture

        return ConstantTexture(np.float32(v[0]))

    def report_unused(self, where=""):
        # Only the material-level set is checked: the geometry ParamSet also
        # carries shape params (radius, indices, ...) that the shape factory
        # consumes separately (reference core/paramset.h TextureParams
        # ReportUnused checks materialParams).
        self.material.report_unused(where)
