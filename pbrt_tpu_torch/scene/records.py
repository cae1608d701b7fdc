"""Host-side scene description records produced by the api state machine.

These are plain dataclasses (the "SceneDescription" pytree of SURVEY.md
section 7): the parser/api fill them in, and pbrt_tpu_torch.scene.compile
lowers them to device tensors. They replace the reference's
Primitive/Light/VolumeRegion object graphs (reference core/api.cpp
RenderOptions/GraphicsState, :169-242).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from pbrt_tpu_torch.core.transform import Transform
from pbrt_tpu_torch.scene.paramset import ParamSet


@dataclass
class MaterialRecord:
    """A resolved material instance: type + texture descriptors per slot.

    textures maps slot name (e.g. "Kd") -> texture descriptor
    (pbrt_tpu_torch.textures.registry). consts holds non-textured scalars
    (e.g. glass "index"/"Vn", reference materials/glass.cpp:64-69).
    spectra holds material-level constant spectra (metal n/k).
    """

    kind: str
    textures: Dict[str, Any] = field(default_factory=dict)
    consts: Dict[str, float] = field(default_factory=dict)
    spectra: Dict[str, np.ndarray] = field(default_factory=dict)
    # for "mix": the two child materials
    children: Tuple[Optional["MaterialRecord"], Optional["MaterialRecord"]] = (None, None)

    def dispersive(self) -> bool:
        """reference materials/glass.h:57 — dispersive iff Vn > 0."""
        return self.kind == "glass" and self.consts.get("Vn", 0.0) > 0.0


@dataclass
class AreaLightRecord:
    kind: str
    params: ParamSet
    # filled per-shape at compile time


@dataclass
class ShapeRecord:
    kind: str
    params: ParamSet
    o2w: Transform
    w2o: Transform
    reverse_orientation: bool
    material: Optional[MaterialRecord]
    area_light: Optional[AreaLightRecord] = None
    animated: object = None  # animated CTM (motion blur; not yet ported)
    # alpha-texture masking (reference shapes/trianglemesh.cpp:379-437):
    # a texture object (resolved from the graphics state at Shape time)
    # or a constant float; None = fully opaque
    alpha_tex: object = None


@dataclass
class LightRecord:
    kind: str
    params: ParamSet
    l2w: Transform
    n_samples: int = 1


@dataclass
class VolumeRecord:
    kind: str
    params: ParamSet
    v2w: Transform


@dataclass
class InstanceRecord:
    """ObjectInstance use-site: instance-to-world transform over a named
    shape list (reference core/api.cpp:1106-1158)."""

    name: str
    shapes: List[ShapeRecord]
    i2w: Transform
    animated: object = None


@dataclass
class RenderOptions:
    transform_start_time: float = 0.0
    transform_end_time: float = 1.0
    filter_name: str = "box"
    filter_params: ParamSet = field(default_factory=ParamSet)
    film_name: str = "image"
    film_params: ParamSet = field(default_factory=ParamSet)
    sampler_name: str = "lowdiscrepancy"
    sampler_params: ParamSet = field(default_factory=ParamSet)
    accelerator_name: str = "bvh"
    accelerator_params: ParamSet = field(default_factory=ParamSet)
    renderer_name: str = "sampler"
    renderer_params: ParamSet = field(default_factory=ParamSet)
    surf_integrator_name: str = "directlighting"
    surf_integrator_params: ParamSet = field(default_factory=ParamSet)
    vol_integrator_name: str = "emission"
    vol_integrator_params: ParamSet = field(default_factory=ParamSet)
    camera_name: str = "perspective"
    camera_params: ParamSet = field(default_factory=ParamSet)
    camera_to_world: Optional[Transform] = None  # world-to-camera inverse
    camera_to_world_end: Optional[Transform] = None
    lights: List[LightRecord] = field(default_factory=list)
    shapes: List[ShapeRecord] = field(default_factory=list)
    instances: List[InstanceRecord] = field(default_factory=list)
    volume_regions: List[VolumeRecord] = field(default_factory=list)
