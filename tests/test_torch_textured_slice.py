"""The textured slice as a whole, port against the JAX package.

One scene of triangle meshes uses every material kind the port gained
with textures (translucent, metal, substrate with anisotropic
roughness, uber with opacity, shinymetal, measured, subsurface,
kdsubsurface, mix), textures of each family (checkerboard and dots;
marble and wrinkled noise; an image map), bump maps and an alpha-masked
quad in front. Both packages render it at the same seed through `path`
and `directlighting`.

Limits (the render limits of tests/test_torch_slice.py): image mean
within 0.5%, and at least 99% of pixels within 1e-3 relative.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu_torch.io.image import write_image
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from test_torch_alpha_bump import tri_quad
from test_torch_materials import write_const_merl
from test_torch_slice import _render

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers


def uv_sphere_mesh(n, radius, center):
    """A tessellated sphere with (phi, theta) uv, as a trianglemesh line."""
    th = np.linspace(0.0, np.pi, n + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    P = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1)
    P = P.reshape(-1, 3) * radius + np.asarray(center)
    uv = np.stack([pp / (2 * np.pi), tt / np.pi], -1).reshape(-1, 2)
    idx = []
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j
            idx += [a, a + n + 1, a + 1, a + 1, a + n + 1, a + n + 2]
    return ('Shape "trianglemesh" "integer indices" [' + " ".join(map(str, idx))
            + '] "point P" [' + " ".join(f"{v:.5f}" for v in P.ravel())
            + '] "float uv" [' + " ".join(f"{v:.5f}" for v in uv.ravel()) + "]\n")


def slice_scene(tmp, res=16, spp=2, integrator='"path" "integer maxdepth" [1]'):
    """Triangle meshes in every material kind the port gained here, with
    textures of each family (analytic, noise, image), bump maps and an
    alpha-masked quad in front."""
    merl = tmp / "const.binary"
    if not merl.exists():
        write_const_merl(str(merl))
        rng = np.random.RandomState(33)
        write_image(str(tmp / "floor.pfm"), rng.uniform(0.1, 0.9, (16, 16, 3)).astype(np.float32))
    mats = [
        'Material "translucent" "texture Kd" "marble" "float roughness" [.2]',
        'Material "metal" "float roughness" [.05]',
        'Material "substrate" "texture Kd" "chk" "float uroughness" [.05] '
        '"float vroughness" [.3] "texture bumpmap" "bumps"',
        'Material "uber" "rgb Kd" [.4 .4 .2] "rgb Kt" [.2 .2 .2] "rgb opacity" [.7 .7 .7]',
        'Material "shinymetal" "texture Ks" "dots" "rgb Kr" [.5 .5 .5]',
        f'Material "measured" "string filename" "{merl}"',
        'Material "subsurface" "string name" "Skin1"',
        'Material "kdsubsurface" "rgb Kd" [.6 .5 .4]',
        'MakeNamedMaterial "a" "string type" "plastic" "rgb Kd" [.1 .5 .1]\n'
        'MakeNamedMaterial "b" "string type" "metal"\n'
        'Material "mix" "string namedmaterial1" "a" "string namedmaterial2" "b" '
        '"texture amount" "chk"',
    ]
    s = (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
         f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]\n'
         'LookAt 0 2.2 -6  0 0.2 0  0 1 0\nCamera "perspective" "float fov" [42]\n'
         f'SurfaceIntegrator {integrator}\nWorldBegin\n'
         'LightSource "point" "point from" [1 5 -4] "rgb I" [30 30 30]\n'
         'LightSource "distant" "point from" [-1 3 -2] "point to" [0 0 0] "rgb L" [1 1 1]\n'
         'Texture "chk" "color" "checkerboard" "rgb tex1" [.8 .6 .2] "rgb tex2" [.2 .3 .7] '
         '"float uscale" [6] "float vscale" [6]\n'
         'Texture "dots" "color" "dots" "rgb inside" [.9 .9 .9] "rgb outside" [.3 .3 .3] '
         '"float uscale" [8] "float vscale" [8]\n'
         'Texture "marble" "color" "marble" "float scale" [3] "integer octaves" [2]\n'
         'Texture "bump" "float" "wrinkled" "integer octaves" [2]\n'
         'Texture "bumps" "float" "scale" "texture tex1" "bump" "float tex2" [.02]\n'
         f'Texture "floor" "color" "imagemap" "string filename" "{tmp}/floor.pfm" '
         '"float uscale" [3] "float vscale" [3]\n'
         'Texture "cut" "float" "checkerboard" "float tex1" [1] "float tex2" [0] '
         '"float uscale" [3] "float vscale" [3]\n')
    for k, m in enumerate(mats):
        center = (-2.4 + 1.2 * (k % 5), 0.45, 0.6 * (k // 5))
        s += f"AttributeBegin\n{m}\n" + uv_sphere_mesh(6, 0.45, center) + "AttributeEnd\n"
    s += ('AttributeBegin\nMaterial "matte" "texture Kd" "floor" "texture bumpmap" "bumps"\n'
          + tri_quad([(-4, 0, -3), (4, 0, -3), (4, 0, 4), (-4, 0, 4)]) + "AttributeEnd\n"
          'AttributeBegin\nMaterial "plastic" "rgb Kd" [.6 .2 .2]\n'
          + tri_quad([(-1.2, 0, -1.2), (1.2, 0, -1.2), (1.2, 1.6, -1.2), (-1.2, 1.6, -1.2)])[:-1]
          + ' "texture alpha" "cut"\nAttributeEnd\n')
    return s + "WorldEnd\n"


@pytest.mark.parametrize("integrator", ['"path" "integer maxdepth" [1]',
                                        '"directlighting" "integer maxdepth" [1]'])
def test_textured_slice_matches_jax(tmp_path, integrator):
    """16 x 16, 2 spp, maxdepth 1 (each depth is another unrolled copy of
    the material graph for XLA to compile; depth 0 already shades, samples
    the BSDF with u3 / u_pick and traces through the alpha mask)."""
    path = tmp_path / "slice.pbrt"
    path.write_text(slice_scene(tmp_path, integrator=integrator))
    ref = _render(j_api, j_parser, path)
    got = _render(t_api, t_parser, path)
    assert got.shape == ref.shape == (16, 16, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99
