"""Textures: only the constant texture is ported.

Port of the ConstantTexture of pbrt_tpu/textures/registry.py: the
texture the parameter lookups (scene/paramset.py TextureParams) create
for plain values, and the named "constant" texture of a `Texture`
statement. Every other texture class fails with a clear error.
"""
from __future__ import annotations

import numpy as np

from pbrt_tpu_torch.core.error import PbrtError


class ConstantTexture:
    def __init__(self, value):
        self.value = np.asarray(value, np.float32)
        self.spectral = self.value.ndim > 0


def make_texture(tex_class: str, tex_type: str, tex_to_world, tp):
    """Named texture factory (reference make_texture, "constant" branch)."""
    if tex_class == "constant":
        if tex_type == "spectrum":
            return ConstantTexture(tp.find_spectrum("value", 1.0))
        return ConstantTexture(np.float32(tp.find_float("value", 1.0)))
    raise PbrtError(f'not yet ported: {tex_type} texture "{tex_class}"')
