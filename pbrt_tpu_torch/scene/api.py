"""The pbrt scene API state machine.

Replaces reference core/api.{h,cpp}: the 40 `pbrt*()` C functions, the
Options/World-block state machine (api.cpp:276-318), the two-keyframe
TransformSet (api.cpp:142-166), the GraphicsState attribute stack
(api.cpp:217,284-287), named coordinate systems / named materials /
object instancing (api.cpp:1106-1158). Instead of instantiating C++
plugin objects, statements append host-side records
(pbrt_tpu_torch.scene.records) that the scene compiler lowers to tensors.

Port of pbrt_tpu/scene/api.py, carried over unchanged except that
WorldEnd calls this package's render driver and an animated transform
is recorded as its end-of-shutter Transform (motion blur is not yet
ported; the compiler rejects it).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from pbrt_tpu_torch.core.error import PbrtError, severe, warning
from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.scene.paramset import ParamSet, TextureParams
from pbrt_tpu_torch.scene.records import (
    AreaLightRecord,
    InstanceRecord,
    LightRecord,
    MaterialRecord,
    RenderOptions,
    ShapeRecord,
    VolumeRecord,
)

MAX_TRANSFORMS = 2
START_TRANSFORM_BITS = 1 << 0
END_TRANSFORM_BITS = 1 << 1
ALL_TRANSFORMS_BITS = (1 << MAX_TRANSFORMS) - 1

STATE_UNINITIALIZED, STATE_OPTIONS_BLOCK, STATE_WORLD_BLOCK = 0, 1, 2


class TransformSet:
    def __init__(self):
        self.t = [Transform(), Transform()]

    def copy(self):
        ts = TransformSet()
        ts.t = list(self.t)
        return ts

    def inverse(self):
        ts = TransformSet()
        ts.t = [x.inverse() for x in self.t]
        return ts

    def is_animated(self):
        return not np.allclose(self.t[0].m, self.t[1].m)


@dataclass
class GraphicsState:
    material_name: str = "matte"
    material_params: ParamSet = field(default_factory=ParamSet)
    float_textures: Dict[str, object] = field(default_factory=dict)
    spectrum_textures: Dict[str, object] = field(default_factory=dict)
    named_materials: Dict[str, MaterialRecord] = field(default_factory=dict)
    current_named_material: str = ""
    area_light: str = ""
    area_light_params: ParamSet = field(default_factory=ParamSet)
    reverse_orientation: bool = False

    def copy(self):
        g = GraphicsState(
            material_name=self.material_name,
            material_params=self.material_params,
            float_textures=dict(self.float_textures),
            spectrum_textures=dict(self.spectrum_textures),
            named_materials=dict(self.named_materials),
            current_named_material=self.current_named_material,
            area_light=self.area_light,
            area_light_params=self.area_light_params,
            reverse_orientation=self.reverse_orientation,
        )
        return g

    def create_material(self, geom_params: ParamSet) -> MaterialRecord:
        from pbrt_tpu_torch.materials.registry import make_material

        tp = TextureParams(
            geom_params, self.material_params, self.float_textures, self.spectrum_textures
        )
        if self.current_named_material and self.current_named_material in self.named_materials:
            return self.named_materials[self.current_named_material]
        mtl = make_material(self.material_name, tp, self.named_materials)
        if mtl is None:
            mtl = make_material("matte", tp, self.named_materials)
        return mtl


class ApiState:
    def __init__(self):
        self.state = STATE_UNINITIALIZED
        self.cur_transform = TransformSet()
        self.active_transform_bits = ALL_TRANSFORMS_BITS
        self.named_coordinate_systems: Dict[str, TransformSet] = {}
        self.render_options: Optional[RenderOptions] = None
        self.graphics_state = GraphicsState()
        self.pushed_graphics_states: List[GraphicsState] = []
        self.pushed_transforms: List[TransformSet] = []
        self.pushed_active_bits: List[int] = []
        self.object_instances: Dict[str, List[ShapeRecord]] = {}
        self.current_instance: Optional[List[ShapeRecord]] = None
        self.output = None  # rendered result (set at WorldEnd)
        self.options = {}  # CLI Options (quick, quiet, ncores...)


_state = ApiState()


def _verify_initialized(func: str):
    if _state.state == STATE_UNINITIALIZED:
        severe(f"pbrtInit() must be before calling `{func}()`")


def _verify_options(func: str):
    _verify_initialized(func)
    if _state.state == STATE_WORLD_BLOCK:
        severe(f"Options cannot be set inside world block; `{func}` not allowed.")


def _verify_world(func: str):
    _verify_initialized(func)
    if _state.state == STATE_OPTIONS_BLOCK:
        severe(f"Scene description must be inside world block; `{func}` not allowed.")


def _for_active_transforms(fn):
    for i in range(MAX_TRANSFORMS):
        if _state.active_transform_bits & (1 << i):
            _state.cur_transform.t[i] = fn(_state.cur_transform.t[i])


# ---------------------------------------------------------------------------
# Init / cleanup

def pbrt_init(options: Optional[dict] = None):
    global _state
    if _state.state != STATE_UNINITIALIZED:
        severe("pbrtInit() has already been called.")
    _state = ApiState()
    _state.state = STATE_OPTIONS_BLOCK
    _state.render_options = RenderOptions()
    _state.options = dict(options or {})
    from pbrt_tpu_torch.core import error

    error.quiet = bool(_state.options.get("quiet", False))
    error.verbose = bool(_state.options.get("verbose", False))


def pbrt_cleanup():
    global _state
    if _state.state == STATE_UNINITIALIZED:
        severe("pbrtCleanup() called without pbrtInit().")
    elif _state.state == STATE_WORLD_BLOCK:
        severe("pbrtCleanup() called while inside world block.")
    _state = ApiState()


def get_state() -> ApiState:
    return _state


# ---------------------------------------------------------------------------
# Transforms

def pbrt_identity():
    _verify_initialized("Identity")
    _for_active_transforms(lambda t: Transform())


def pbrt_translate(dx, dy, dz):
    _verify_initialized("Translate")
    _for_active_transforms(lambda t: t * Transform.translate([dx, dy, dz]))


def pbrt_rotate(angle, ax, ay, az):
    _verify_initialized("Rotate")
    _for_active_transforms(lambda t: t * Transform.rotate(angle, [ax, ay, az]))


def pbrt_scale(sx, sy, sz):
    _verify_initialized("Scale")
    _for_active_transforms(lambda t: t * Transform.scale(sx, sy, sz))


def pbrt_look_at(eye, look, up):
    _verify_initialized("LookAt")
    # LookAt gives camera-to-world; the CTM accumulates world-to-camera
    _for_active_transforms(lambda t: t * Transform.look_at(eye, look, up).inverse())


def pbrt_concat_transform(m16):
    _verify_initialized("ConcatTransform")
    m = np.asarray(m16, np.float64).reshape(4, 4).T  # column-major in file
    _for_active_transforms(lambda t: t * Transform(m))


def pbrt_transform(m16):
    _verify_initialized("Transform")
    m = np.asarray(m16, np.float64).reshape(4, 4).T
    _for_active_transforms(lambda t: Transform(m))


def pbrt_coordinate_system(name):
    _verify_initialized("CoordinateSystem")
    _state.named_coordinate_systems[name] = _state.cur_transform.copy()


def pbrt_coord_sys_transform(name):
    _verify_initialized("CoordSysTransform")
    if name in _state.named_coordinate_systems:
        _state.cur_transform = _state.named_coordinate_systems[name].copy()
    else:
        warning(f'Couldn\'t find named coordinate system "{name}"')


def pbrt_active_transform(which: str):
    if which == "All":
        _state.active_transform_bits = ALL_TRANSFORMS_BITS
    elif which == "StartTime":
        _state.active_transform_bits = START_TRANSFORM_BITS
    elif which == "EndTime":
        _state.active_transform_bits = END_TRANSFORM_BITS
    else:
        raise PbrtError(f"ActiveTransform: unknown time {which!r}")


def pbrt_transform_times(start, end):
    _verify_options("TransformTimes")
    _state.render_options.transform_start_time = start
    _state.render_options.transform_end_time = end


# ---------------------------------------------------------------------------
# Options-block statements

def pbrt_pixel_filter(name, params):
    _verify_options("PixelFilter")
    _state.render_options.filter_name = name
    _state.render_options.filter_params = params


def pbrt_film(name, params):
    _verify_options("Film")
    _state.render_options.film_name = name
    _state.render_options.film_params = params


def pbrt_sampler(name, params):
    _verify_options("Sampler")
    _state.render_options.sampler_name = name
    _state.render_options.sampler_params = params


def pbrt_accelerator(name, params):
    _verify_options("Accelerator")
    _state.render_options.accelerator_name = name
    _state.render_options.accelerator_params = params


def pbrt_surface_integrator(name, params):
    _verify_options("SurfaceIntegrator")
    _state.render_options.surf_integrator_name = name
    _state.render_options.surf_integrator_params = params


def pbrt_volume_integrator(name, params):
    _verify_options("VolumeIntegrator")
    _state.render_options.vol_integrator_name = name
    _state.render_options.vol_integrator_params = params


def pbrt_renderer(name, params):
    _verify_options("Renderer")
    _state.render_options.renderer_name = name
    _state.render_options.renderer_params = params


def pbrt_camera(name, params):
    _verify_options("Camera")
    ro = _state.render_options
    ro.camera_name = name
    ro.camera_params = params
    # CTM is world-to-camera; store camera-to-world
    ro.camera_to_world = _state.cur_transform.t[0].inverse()
    ro.camera_to_world_end = _state.cur_transform.t[1].inverse()
    _state.named_coordinate_systems["camera"] = _state.cur_transform.inverse()


# ---------------------------------------------------------------------------
# World block

def pbrt_world_begin():
    _verify_options("WorldBegin")
    _state.state = STATE_WORLD_BLOCK
    _state.cur_transform = TransformSet()
    _state.active_transform_bits = ALL_TRANSFORMS_BITS
    _state.named_coordinate_systems["world"] = _state.cur_transform.copy()


def pbrt_attribute_begin():
    _verify_world("AttributeBegin")
    _state.pushed_graphics_states.append(_state.graphics_state.copy())
    _state.pushed_transforms.append(_state.cur_transform.copy())
    _state.pushed_active_bits.append(_state.active_transform_bits)


def pbrt_attribute_end():
    _verify_world("AttributeEnd")
    if not _state.pushed_graphics_states:
        warning("Unmatched AttributeEnd encountered. Ignoring it.")
        return
    _state.graphics_state = _state.pushed_graphics_states.pop()
    _state.cur_transform = _state.pushed_transforms.pop()
    _state.active_transform_bits = _state.pushed_active_bits.pop()


def pbrt_transform_begin():
    _verify_world("TransformBegin")
    _state.pushed_transforms.append(_state.cur_transform.copy())
    _state.pushed_active_bits.append(_state.active_transform_bits)


def pbrt_transform_end():
    _verify_world("TransformEnd")
    if not _state.pushed_transforms:
        warning("Unmatched TransformEnd encountered. Ignoring it.")
        return
    _state.cur_transform = _state.pushed_transforms.pop()
    _state.active_transform_bits = _state.pushed_active_bits.pop()


def pbrt_texture(name, tex_type, tex_class, params):
    _verify_world("Texture")
    from pbrt_tpu_torch.textures.registry import make_texture

    gs = _state.graphics_state
    tp = TextureParams(params, ParamSet(), gs.float_textures, gs.spectrum_textures)
    if tex_type == "float":
        if name in gs.float_textures:
            warning(f'Texture "{name}" being redefined')
        tex = make_texture(tex_class, "float", _state.cur_transform.t[0], tp)
        if tex is not None:
            gs.float_textures[name] = tex
    elif tex_type in ("color", "spectrum"):
        if name in gs.spectrum_textures:
            warning(f'Texture "{name}" being redefined')
        tex = make_texture(tex_class, "spectrum", _state.cur_transform.t[0], tp)
        if tex is not None:
            gs.spectrum_textures[name] = tex
    else:
        raise PbrtError(f'Texture type "{tex_type}" unknown.')


def pbrt_material(name, params):
    _verify_world("Material")
    _state.graphics_state.material_name = name
    _state.graphics_state.material_params = params
    _state.graphics_state.current_named_material = ""


def pbrt_make_named_material(name, params):
    _verify_world("MakeNamedMaterial")
    from pbrt_tpu_torch.materials.registry import make_material

    gs = _state.graphics_state
    tp = TextureParams(params, ParamSet(), gs.float_textures, gs.spectrum_textures)
    mat_type = params.find_one_string("type", "")
    if not mat_type:
        severe("No parameter string \"type\" found in MakeNamedMaterial")
    mtl = make_material(mat_type, tp, gs.named_materials)
    if mtl is not None:
        gs.named_materials[name] = mtl


def pbrt_named_material(name):
    _verify_world("NamedMaterial")
    _state.graphics_state.current_named_material = name


def pbrt_light_source(name, params):
    _verify_world("LightSource")
    _state.render_options.lights.append(
        LightRecord(kind=name, params=params, l2w=_state.cur_transform.t[0])
    )


def pbrt_area_light_source(name, params):
    _verify_world("AreaLightSource")
    _state.graphics_state.area_light = name
    _state.graphics_state.area_light_params = params


def pbrt_shape(name, params):
    _verify_world("Shape")
    gs = _state.graphics_state
    area_light = None
    if gs.area_light:
        area_light = AreaLightRecord(kind=gs.area_light, params=gs.area_light_params)
    animated = None
    o2w = _state.cur_transform.t[0]
    if _state.cur_transform.is_animated():
        animated = _state.cur_transform.t[1]
    # "alpha" masking param (reference shapes/trianglemesh.cpp:379-437):
    # either a named float texture or a constant float
    alpha_tex = None
    tex_name = params.find_texture("alpha")
    if tex_name:
        alpha_tex = gs.float_textures.get(tex_name)
        if alpha_tex is None:
            warning(f'Couldn\'t find float texture "{tex_name}" for "alpha"')
    else:
        a = params.find_float("alpha")
        if a is not None and len(a):
            alpha_tex = float(a[0])
    rec = ShapeRecord(
        kind=name,
        params=params,
        o2w=o2w,
        w2o=o2w.inverse(),
        reverse_orientation=gs.reverse_orientation,
        material=gs.create_material(params),
        area_light=area_light,
        animated=animated,
        alpha_tex=alpha_tex,
    )
    if _state.current_instance is not None:
        if area_light is not None:
            warning("Area lights not supported with object instancing")
        _state.current_instance.append(rec)
    else:
        _state.render_options.shapes.append(rec)


def pbrt_reverse_orientation():
    _verify_world("ReverseOrientation")
    _state.graphics_state.reverse_orientation = not _state.graphics_state.reverse_orientation


def pbrt_volume(name, params):
    _verify_world("Volume")
    _state.render_options.volume_regions.append(
        VolumeRecord(kind=name, params=params, v2w=_state.cur_transform.t[0])
    )


def pbrt_object_begin(name):
    _verify_world("ObjectBegin")
    pbrt_attribute_begin()
    if _state.current_instance is not None:
        severe("ObjectBegin called inside of instance definition")
    _state.object_instances[name] = []
    _state.current_instance = _state.object_instances[name]


def pbrt_object_end():
    _verify_world("ObjectEnd")
    if _state.current_instance is None:
        severe("ObjectEnd called outside of instance definition")
    _state.current_instance = None
    pbrt_attribute_end()


def pbrt_object_instance(name):
    _verify_world("ObjectInstance")
    if _state.current_instance is not None:
        severe("ObjectInstance can't be called inside instance definition")
    if name not in _state.object_instances:
        severe(f'Unable to find instance named "{name}"')
        return
    shapes = _state.object_instances[name]
    if not shapes:
        return
    animated = None
    if _state.cur_transform.is_animated():
        animated = _state.cur_transform.t[1]
    _state.render_options.instances.append(
        InstanceRecord(name=name, shapes=shapes, i2w=_state.cur_transform.t[0], animated=animated)
    )


def pbrt_world_end(render: bool = True):
    _verify_world("WorldEnd")
    # pop any dangling state
    while _state.pushed_graphics_states:
        warning("Missing end to AttributeBegin")
        _state.pushed_graphics_states.pop()
        _state.pushed_transforms.pop()
        _state.pushed_active_bits.pop()
    while _state.pushed_transforms:
        warning("Missing end to TransformBegin")
        _state.pushed_transforms.pop()
        _state.pushed_active_bits.pop()
    result = None
    if render:
        from pbrt_tpu_torch.renderers.driver import render_scene

        result = render_scene(_state.render_options, _state.options)
        _state.output = result
    _state.state = STATE_OPTIONS_BLOCK
    _state.graphics_state = GraphicsState()
    _state.cur_transform = TransformSet()
    _state.active_transform_bits = ALL_TRANSFORMS_BITS
    _state.named_coordinate_systems.clear()
    return result
