#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pbrt_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from pbrt_tpu_torch/csrc/ (and counts the
instructions of each kernel's inner loop in the built library), holds
each kernel against its plain torch version on the card at the main
path's shapes (K1 bit for bit on a random set and on every launch of the
small render; K2 on every wave of three 1024^2 ray sets, traversed whole
and cut into the render's 65,536-ray traversals), renders the
135k-triangle bench scene (wide pipeline, kernel K2) and a small
mixed-material scene (flat t-pass, kernel K1) through the CLI entry
point, checks the images, renders each scene once more with CUDA events
around every launch of its kernel, renders the reference-binary goldens
matte, meshdl, mesh, smoke and vol (quadrics, directlighting, path,
single scattering) against their reference images and the CPU render
([9]), renders benchvol (the bench geometry with a glass sphere, a disk
light and a homogeneous volume) with event spans around the quadric
fold, the volume march and K2 ([10]), the exact rainbowc golden within
its reference-binary bounds and against the CPU on a crop ([11]),
bench.py's photon legs ([12]) and benchphoton ([13]), benchtex (the
bench geometry in textured, bump-mapped mix and uber materials) with
event spans around K2 and the texture and material evaluation ([14]),
and a small textured scene (every further material kind, an image map,
a bump map, an alpha mask) on the card against the CPU, every K1 launch
bit for bit ([15]), the lights, samplers, cameras, motion and
checkpoint slice ([16]-[20]), and the long tail ([21]-[25]): the bench
geometry through the realistic lens camera ([21]) and under
irradiancecache ([22]), the goldens irr and dprt ([23]), the small scene
under igi, dipolesubsurface, diffuseprt, glossyprt and the
surfacepoints -> createprobes -> useprobes chain, every K1 launch bit
for bit ([24]), and autofocus on the card against the CPU ([25]); then
metropolis ([26]: the bidirectional paths of 4,096 chains on the small
scene, every K1 launch bit for bit, against the CPU, and on the bench
geometry, every K2 wave checked; MLT against the sampler renderer;
benchmlt, the bench geometry under metropolis), the grid and kd-tree
accelerators ([27]: the small scene card vs CPU vs the default
accelerator; the bench geometry under the grid and benchkd under the
kd-tree, timed with their host builds), aggregatetest on the motion
bench geometry ([28]) and the tools ([29]: bsdftest card vs CPU,
exrdiff, obj2pbrt); then gradients ([30]: test_grad.py's four
estimators card vs CPU vs central differences; d mean / d albedo of the
small scene (K1, every launch checked) and of the bench geometry at
1024^2, the grad leg of bench.py, K2) and process groups ([31]:
tests/test_distributed.py's scene through --distributed at world size 1
over NCCL, bit for bit, and over two gloo ranks sharing the card; the
scene with the bench geometry at world size 1, K2 counted) and the
pure-Python BVH builders ([32]: the native builder refused, the bench
geometry's sah and aac trees built in Python, their invariants, K2 over
one 256^2 view of camera rays through each, every wave bit for bit, and
against the native tree's traversal); then it prints one JSON line per
the contract below. Every phase raises on
failure; the script then exits
non-zero and prints no result. It needs no network and no JAX.

    python3 chip_smoke.py --profile   # also: bench render under torch.profiler

Output, in order: device line (nvidia-smi name and power limit, torch
and CUDA versions), build report, kernel comparisons, renders, then
  {"kernels": [{"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "tests", "live_share" (K1), ...}, ...]}
  <nvidia-smi name, power.limit>
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Bounds: a Moller-Trumbore test is MT_FLOPS float32 operations (the count
in csrc/bvh_sweep.cu); the bound is the larger of operations over the
H100 SXM's float32 peak and the bytes that must move (each input read
once, each output written once; for K2 the leaf blocks this run's pair
lists name) over its HBM rate. K1 tests live rays only (tmin < tmax), so
its bound counts live rays x triangles; the bound over all rays is
logged beside it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T_RTOL = 1e-5        # kernel vs plain: t within 1e-5 relative, prim identical
BENCH_RES = 1024
SMALL_RES = 256
RENDER_RAYS = 1 << 16  # rays per traversal in the render (renderers/driver.py tile)
MT_FLOPS = 46          # float32 operations of one Moller-Trumbore test
PEAK_F32 = 67e12       # H100 SXM float32 outside the tensor cores, FLOP/s (data sheet)
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s (data sheet)
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")
# the reference-binary goldens the port renders, with the bounds of
# tests/test_reference_golden.py: (scene, mean-level rtol, mean abs diff / level)
GOLDENS = (("matte", 0.02, 0.03), ("meshdl", 0.03, 0.08), ("mesh", 0.05, 0.15),
           ("smoke", 0.05, 0.10), ("vol", 0.05, 0.08), ("disp", 0.08, 0.30),
           ("irr", 0.08, 0.20), ("dprt", 0.08, 0.20))
GOLDENS_MAIN = ("matte", "meshdl", "mesh", "smoke", "vol", "disp")   # [9]; [23] irr and dprt
BENCHVOL_RES = 1024
BENCHVOL_CHECK_RES = 16   # benchvol's card-vs-CPU check
RAINBOWC_BOUNDS = (0.05, 0.15)    # rainbowc's reference-binary bounds (mean ratio, MAD / level)
RAINBOWC_CROP = (0.375, 0.625, 0.375, 0.625)   # 24 x 24 of 96 x 96
BENCHTEX_RES = 1024
SMALLTEX_RES = 32          # [15]'s card-vs-CPU size (4 spp)
MERL_DIMS = (90, 90, 180)  # MERL theta_h x theta_d x phi_d (materials/measured.py)
S_BINS = 30                # spectral bins (pbrt_tpu_torch/core/spectrum.py)
SHOOT_B = 32768            # photon paths per shooting batch at large quotas
KNN_P, KNN_Q, KNN_K = 1_000_000, 65536, 500   # [12]'s kNN leg
MARCH_SIDE, MARCH_STEPS = 128, 64              # [12]'s march leg
# benchphoton at 512^2 took 188.6 s (render 178.6 s) on an H100 80GB HBM3 at 700 W,
# over the 180 s its phase may take: cut to 256^2 (PERF.md)
BENCHPHOTON_RES = 256
BENCHENV_RES = 1024
ENV_W, ENV_H = 1024, 512   # [16]'s equirectangular map
SLICE_RES = 32             # [17]-[20] and [24]'s card-vs-CPU size
MOTION_BENCH_RES = 256     # [19b]: the bench geometry moving, t_pass_bvh
MOTION_CROP = (0.78125, 0.84375, 0.46875, 0.53125)   # [19b]'s 16 x 16 CPU crop (sphere edge)
LENS = os.path.join(REPO, "tests", "fixtures", "biconvex.dat")   # f ~ 50.85 mm singlet
LENS_INV_F = 0.5 * (2.0 / 50.0 + 0.5 * 5.0 / (1.5 * 50.0 * -50.0))   # its thick-lens 1/f
BENCHLENS_RES = 1024
BENCHLENS_SCALE, BENCHLENS_DIST = 100.0, 525.0   # bench geometry x 100, its sphere 525 away
BENCHLENS_CROP = (0.25, 0.265625, 0.5, 0.515625)   # [21]'s 16 x 16 CPU crop
BENCHIRR_RES = 512         # [22], cut from 1024^2: ~17 closest-hit + 17 shadow traversals a tile
BENCHIRR_CROP = (0.4375, 0.46875, 0.28125, 0.3125)   # [22]'s 16 x 16 CPU crop (on the sphere)
AF_RES, AF_OBJ = 48, 500.0   # [25]: the textured plane 500 units behind the lens
MLT_W = 4096               # [26]: the chains in flight (renderers/metropolis.py W_CHAINS)
MLT_RES = 32               # [26b]: MLT against the sampler renderer on the small scene
# [26c]: benchmlt, the bench geometry under metropolis; cut from 256^2,
# which took 62.15 s on an H100 80GB HBM3 at 700 W (PERF.md)
BENCHMLT_RES = 128
GRID_BENCH_RES = 256       # [27]: the bench geometry under Accelerator "grid"
# [27]'s kd-tree scene: the bench layout with a 100 x 100 sphere (20,002
# triangles), the largest of scripts/port_accel_build_times.py's sizes
# whose kd-tree build took at most 30 s on a CPU (28.9 s; PERF.md)
KD_SPHERE, KD_RES = 100, 128


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Scenes (NumPy, deterministic)

def uv_sphere(n_theta, n_phi, radius, center):
    """(P [V,3], indices [T*3]) with 2*n_theta*n_phi triangles; the
    layout of scripts/bench_scene.py uv_sphere."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    P = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)], -1)
    P = P.reshape(-1, 3) * radius + np.asarray(center)
    W = n_phi + 1
    i, j = np.meshgrid(np.arange(n_theta), np.arange(n_phi), indexing="ij")
    a = (i * W + j).ravel()
    b, c = a + 1, a + W
    d = c + 1
    idx = np.stack([a, c, b, b, c, d], -1).reshape(-1)
    return P.astype(np.float32), idx.astype(np.int32)


def mesh(P, idx):
    return ('Shape "trianglemesh" "integer indices" [' + " ".join(map(str, idx.tolist()))
            + '] "point P" [' + " ".join(f"{v:.7g}" for v in np.ravel(P)) + "]\n")


FLOOR = np.array([[-12, -0.6, -12], [12, -0.6, -12], [12, -0.6, 12], [-12, -0.6, 12]],
                 np.float32)
FLOOR_IDX = np.array([0, 2, 1, 0, 3, 2], np.int32)


def bench_geometry():
    """The bench scene's triangles (scripts/bench_scene.py): a 260x260
    UV sphere (135,200 tris) over a two-triangle floor."""
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    tris = [P[idx.reshape(-1, 3)], FLOOR[FLOOR_IDX.reshape(-1, 3)]]
    t = np.concatenate(tris)
    return t[:, 0], t[:, 1] - t[:, 0], t[:, 2] - t[:, 0]


def bench_scene_text(res):
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            'LookAt 0 1.2 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
            'LightSource "point" "point from" [3 6 -4] "rgb I" [60 60 60]\n'
            'Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx)
            + 'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX)
            + "WorldEnd\n")


def benchvol_scene_text(res):
    """The bench geometry (135,202 triangles) with a dispersive glass
    sphere, a disk area light facing down, the bench point light and a
    homogeneous volume over the scene; directlighting (maxdepth 5) and
    single scattering (stepsize 0.5: 16 march steps over the box)."""
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            'LookAt 0 1.2 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "directlighting" "integer maxdepth" [5]\n'
            'VolumeIntegrator "single" "float stepsize" [0.5]\nWorldBegin\n'
            'LightSource "point" "point from" [3 6 -4] "rgb I" [60 60 60]\n'
            'AttributeBegin\nTranslate 0 3 0\nRotate 90 1 0 0\n'
            'AreaLightSource "diffuse" "rgb L" [10 10 10]\n'
            'Shape "disk" "float radius" [1]\nAttributeEnd\n'
            'Volume "homogeneous" "point p0" [-2.5 -0.6 -2.5] "point p1" [2.5 2.0 2.5]\n'
            '    "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.15 0.15 0.15] "float g" [0.3]\n'
            'AttributeBegin\nMaterial "glass" "float index" [1.52] "float Vn" [64.17]\n'
            'Translate 1.6 0 0.2\nShape "sphere" "float radius" [0.5]\nAttributeEnd\n'
            'Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx)
            + 'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX)
            + "WorldEnd\n")


# benchphoton's light and medium: (spot I, point light height, sigma_a),
# raised from (400, 1.9, 0.05) so that every quota fills inside the
# shooter's batch cap (PERF.md, Cells: benchphoton)
BENCHPHOTON_LIGHTS = (2000, 0.7, 0.15)


def benchphoton_scene_text(res, lights=BENCHPHOTON_LIGHTS):
    """The benchvol geometry (135,202 triangles and the glass sphere) lit
    by a spot on the glass sphere and a point light inside the medium,
    under photonmap (final gather) and photonvolume (1M volume photons,
    128 march steps); `lights` is (spot I, point light height, sigma_a)."""
    spot_i, point_y, sigma_a = lights
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            'LookAt 0 1.2 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "photonmap" "integer causticphotons" [200000]\n'
            '    "integer indirectphotons" [200000] "integer nused" [60] "float maxdist" [0.2]\n'
            '    "bool finalgather" ["true"] "integer finalgathersamples" [16]\n'
            'VolumeIntegrator "photonvolume" "integer volumephotons" [1000000]\n'
            '    "integer nused" [100] "float maxdist" [0.4] "float stepsize" [0.05]\n'
            'WorldBegin\n'
            'LightSource "spot" "point from" [1.6 3 0.2] "point to" [1.6 0 0.2]\n'
            f'    "float coneangle" [10] "float conedeltaangle" [2] "rgb I" [{spot_i} {spot_i} {spot_i}]\n'
            f'LightSource "point" "point from" [0 {point_y} -1.5] "rgb I" [20 20 20]\n'
            'Volume "homogeneous" "point p0" [-2.5 -0.6 -2.5] "point p1" [2.5 2.0 2.5]\n'
            f'    "rgb sigma_a" [{sigma_a} {sigma_a} {sigma_a}] "rgb sigma_s" [0.15 0.15 0.15] "float g" [0.3]\n'
            'AttributeBegin\nMaterial "glass" "float index" [1.52] "float Vn" [64.17]\n'
            'Translate 1.6 0 0.2\nShape "sphere" "float radius" [0.5]\nAttributeEnd\n'
            'Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx)
            + 'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX)
            + "WorldEnd\n")


# bench.py's photon legs: a scattering cube and a point light, no surfaces
PHOTON_LEGS_SCENE = """LookAt 0 0.5 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
LightSource "point" "point from" [0 2.5 0] "rgb I" [30 30 30]
Volume "homogeneous" "point p0" [-1.5 -1.2 -1.5] "point p1" [1.5 1.8 1.5]
    "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.9 0.9 0.9]
WorldEnd
"""


def rainbowc_text(crop=None):
    """tests/goldens/rainbowc.pbrt as it stands (its walls' imagemap x
    scale texture reads the missing textures/lines.tga as one white
    texel, as the reference does), optionally cropped."""
    with open(os.path.join(GOLDEN_DIR, "rainbowc.pbrt")) as f:
        s = f.read()
    if crop is not None:
        s = re.sub(r'(Film "image"[^\n]*)', r'\1 "float cropwindow" [%g %g %g %g]' % crop, s)
    return s


def benchtex_image():
    """benchtex's floor image: 1024^2 RGB, 32-texel tiles of seeded
    random colours under diagonal stripes (NumPy, seed 14)."""
    rng = np.random.RandomState(14)
    tiles = np.kron(rng.uniform(0.15, 0.85, (32, 32, 3)), np.ones((32, 32, 1)))
    y, x = np.mgrid[0:1024, 0:1024]
    stripes = 0.75 + 0.25 * np.sin((x + y) * (2 * np.pi / 64.0))
    return (tiles * stripes[..., None]).astype(np.float32)


def benchtex_scene_text(res, img_path):
    """The bench geometry (135,202 triangles) in textured materials: the
    sphere a mix (amount a 3D checkerboard) of a substrate (Kd a marble
    texture, uroughness != vroughness: the anisotropic FresnelBlend) and
    copper metal; the floor, with uv, an uber with an imagemap Kd (EWA,
    repeat) and a scale(dots) Ks, bump-mapped by a wrinkled texture (a
    mix takes no bumpmap in either package: eval_bump reads the top-level
    material's). 1 spp, path maxdepth 5, the bench point light."""
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            'LookAt 0 1.2 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
            'LightSource "point" "point from" [3 6 -4] "rgb I" [60 60 60]\n'
            'Texture "marble" "color" "marble" "float scale" [3] "float variation" [.6]\n'
            'TransformBegin\nScale .25 .25 .25\n'
            'Texture "chk3" "color" "checkerboard" "integer dimension" [3]\n'
            '    "rgb tex1" [.9 .9 .9] "rgb tex2" [.2 .2 .2]\nTransformEnd\n'
            'Texture "wr" "float" "wrinkled" "integer octaves" [6]\n'
            'Texture "bump" "float" "scale" "texture tex1" "wr" "float tex2" [.03]\n'
            f'Texture "img" "color" "imagemap" "string filename" "{img_path}"\n'
            'Texture "dots" "color" "dots" "rgb inside" [.6 .6 .6] "rgb outside" [.05 .05 .05]\n'
            '    "float uscale" [4] "float vscale" [4]\n'
            'Texture "ks" "color" "scale" "texture tex1" "dots" "rgb tex2" [.8 .8 .8]\n'
            'MakeNamedMaterial "sub" "string type" "substrate" "texture Kd" "marble"\n'
            '    "rgb Ks" [.06 .06 .06] "float uroughness" [.02] "float vroughness" [.2]\n'
            'MakeNamedMaterial "cu" "string type" "metal"\n'
            'AttributeBegin\nMaterial "mix" "string namedmaterial1" "sub" '
            '"string namedmaterial2" "cu" "texture amount" "chk3"\n' + mesh(P, idx)
            + 'AttributeEnd\nMaterial "uber" "texture Kd" "img" "texture Ks" "ks" '
            '"float roughness" [.05] "texture bumpmap" "bump"\n'
            + mesh(FLOOR, FLOOR_IDX)[:-1] + ' "float uv" [0 0 6 0 6 6 0 6]\n' + "WorldEnd\n")


def write_const_merl(path, rgb=(0.3, 0.5, 0.2)):
    """A constant MERL binary file: 3 int32 dims, then the R, G, B planes
    (float64) divided by MERL's colour scales (materials/measured.py)."""
    n = MERL_DIMS[0] * MERL_DIMS[1] * MERL_DIMS[2]
    scale = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0])
    with open(path, "wb") as f:
        np.array(MERL_DIMS, np.int32).tofile(f)
        np.concatenate([np.full(n, rgb[c] / scale[c], np.float64) for c in range(3)]).tofile(f)


def smalltex_scene_text(res, spp, img_path, merl_path):
    """The small scene's layout in the materials of this slice: spheres in
    translucent, shinymetal, kdsubsurface and measured (a constant MERL
    file); the floor an imagemap-textured plastic with an fbm bump; a quad
    masked by a 2D checkerboard alpha in front of the first sphere;
    7,206 triangles."""
    quad = np.array([[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]], np.float32)
    s = (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
         f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]\n'
         'PixelFilter "gaussian"\n'
         'LookAt 0 1.5 -5  0 0.3 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
         'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
         'LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]\n'
         f'Texture "img" "color" "imagemap" "string filename" "{img_path}"\n'
         '    "float uscale" [3] "float vscale" [3]\n'
         'Texture "fbm" "float" "fbm" "integer octaves" [5]\n'
         'Texture "bump" "float" "scale" "texture tex1" "fbm" "float tex2" [.02]\n'
         'Texture "cut" "float" "checkerboard" "float tex1" [1] "float tex2" [0]\n'
         '    "float uscale" [4] "float vscale" [4]\n'
         'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [6 6 6]\n'
         + mesh(quad, FLOOR_IDX) + "AttributeEnd\n")
    mats = ['Material "translucent" "rgb Kd" [.5 .4 .3] "rgb reflect" [.5 .5 .5] '
            '"rgb transmit" [.4 .4 .4] "float roughness" [.1]',
            'Material "shinymetal" "rgb Ks" [.7 .6 .4] "rgb Kr" [.3 .3 .3] "float roughness" [.05]',
            'Material "kdsubsurface" "rgb Kd" [.6 .4 .3]',
            f'Material "measured" "string filename" "{merl_path}"']
    for k, m in enumerate(mats):
        P, idx = uv_sphere(30, 30, 0.5, (-1.8 + 1.2 * k, 0.5, 0.0))
        s += f"AttributeBegin\n{m}\n" + mesh(P, idx) + "AttributeEnd\n"
    cut = np.array([[-2.4, 0.0, -0.7], [-1.2, 0.0, -0.7], [-1.2, 1.2, -0.7], [-2.4, 1.2, -0.7]],
                   np.float32)
    s += ('AttributeBegin\nMaterial "matte" "rgb Kd" [.7 .2 .2]\n' + mesh(cut, FLOOR_IDX)[:-1]
          + ' "float uv" [0 0 1 0 1 1 0 1] "texture alpha" "cut"\nAttributeEnd\n')
    floor = FLOOR.copy()
    floor[:, 1] = 0.0
    return (s + 'Material "plastic" "texture Kd" "img" "rgb Ks" [.2 .2 .2] '
            '"texture bumpmap" "bump"\n' + mesh(floor, FLOOR_IDX)[:-1]
            + ' "float uv" [0 0 1 0 1 1 0 1]\n' + "WorldEnd\n")


def small_scene_text(res, spp):
    """Four tessellated spheres (matte, plastic, mirror, dispersive
    glass), a triangle area light, a point light, a floor: 7,204 tris."""
    quad = np.array([[-1, 3, -1], [1, 3, -1], [1, 3, 1], [-1, 3, 1]], np.float32)
    s = (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
         f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]\n'
         'PixelFilter "gaussian"\n'
         'LookAt 0 1.5 -5  0 0.3 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
         'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
         'LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]\n'
         'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [6 6 6]\n'
         + mesh(quad, FLOOR_IDX) + "AttributeEnd\n")
    mats = ['Material "matte" "rgb Kd" [.6 .3 .2]',
            'Material "plastic" "rgb Kd" [.2 .3 .6] "rgb Ks" [.4 .4 .4] "float roughness" [.05]',
            'Material "mirror" "rgb Kr" [.9 .9 .9]',
            'Material "glass" "float index" [1.52] "float Vn" [36.4]']
    for k, m in enumerate(mats):
        P, idx = uv_sphere(30, 30, 0.5, (-1.8 + 1.2 * k, 0.5, 0.0))
        s += f"AttributeBegin\n{m}\n" + mesh(P, idx) + "AttributeEnd\n"
    floor = FLOOR.copy()
    floor[:, 1] = 0.0
    return s + 'Material "matte" "rgb Kd" [.5 .5 .5]\n' + mesh(floor, FLOOR_IDX) + "WorldEnd\n"


def env_map(w, h, seed):
    """A seeded equirectangular sky: a gradient from the zenith (row 0)
    to the horizon, a dark ground half, a bright sun disk and low
    noise."""
    rng = np.random.RandomState(seed)
    v = (np.arange(h) + 0.5) / h
    sky = np.where(v < 0.5, 0.3 + 0.9 * (v / 0.5), 0.15)[:, None, None]
    img = sky * np.array([0.55, 0.7, 1.0])[None, None, :] * np.ones((h, w, 3))
    uu, vv = np.meshgrid((np.arange(w) + 0.5) / w, v)
    sun = (uu - 0.3) ** 2 + ((vv - 0.25) * 2.0) ** 2 < 0.02 ** 2
    img[sun] = (200.0, 180.0, 150.0)
    img = img * (1.0 + 0.05 * rng.rand(h, w, 1))
    return img.astype(np.float32)


def benchenv_scene_text(res, env_path):
    """The bench geometry lit by an infinite light alone (halton, path
    maxdepth 5)."""
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
            'Sampler "halton" "integer pixelsamples" [1]\n'
            'LookAt 0 1.2 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
            'AttributeBegin\nRotate -90 1 0 0\n'
            f'LightSource "infinite" "rgb L" [1 1 1] "string mapname" "{env_path}"\n'
            'AttributeEnd\n'
            'Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx)
            + 'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX)
            + "WorldEnd\n")


def slice_images(tmp):
    """[17]'s seeded light images: an exinfinite sky, a goniometric and a
    projected image -> paths."""
    from pbrt_tpu_torch.io.image import write_image

    rng = np.random.RandomState(17)
    paths = {k: os.path.join(tmp, f"slice_{k}.pfm") for k in ("env", "gonio", "proj")}
    write_image(paths["env"], env_map(64, 32, 17))
    write_image(paths["gonio"], (rng.rand(16, 32, 3) + 0.5).astype(np.float32))
    write_image(paths["proj"], rng.rand(24, 32, 3).astype(np.float32))
    return paths


def small_variant_text(res, spp, sampler=None, camera=None, depth=5, lights=None,
                       moving=False):
    """The small scene with its sampler, camera, maxdepth or point light
    replaced; `moving` translates the mirror sphere's mesh over the
    shutter (TransformTimes 0 1)."""
    s = small_scene_text(res, spp)
    if sampler:
        s = s.replace(f'Sampler "lowdiscrepancy" "integer pixelsamples" [{spp}]', sampler)
    if camera:
        s = s.replace('Camera "perspective" "float fov" [45]', camera)
    s = s.replace('"integer maxdepth" [5]', f'"integer maxdepth" [{depth}]')
    if lights:
        s = s.replace('LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]\n', lights)
    if moving:
        s = s.replace("WorldBegin\n", "TransformTimes 0 1\nWorldBegin\n")
        s = s.replace('AttributeBegin\nMaterial "mirror"',
                      'AttributeBegin\nActiveTransform EndTime\nTranslate 0.6 0.3 0\n'
                      'ActiveTransform All\nMaterial "mirror"')
    return s


def slice_lights_text(paths):
    """[17]'s lights: an exinfinite map, a goniometric and a projection
    light (with the small scene's triangle area light)."""
    return ('AttributeBegin\nRotate -90 1 0 0\nLightSource "exinfinite" "rgb L" [.8 .8 .8] '
            f'"string mapname" "{paths["env"]}"\nAttributeEnd\n'
            'AttributeBegin\nTranslate -1 3 -0.5\nRotate 60 1 0 0\nLightSource "goniometric" '
            f'"rgb I" [10 10 10] "string mapname" "{paths["gonio"]}"\nAttributeEnd\n'
            'AttributeBegin\nTranslate 0.5 4 -0.5\nRotate 90 1 0 0\nLightSource "projection" '
            f'"rgb I" [40 40 40] "float fov" [60] "string mapname" "{paths["proj"]}"\n'
            'AttributeEnd\n')


def motion_bench_text(res, crop=None):
    """The bench geometry with its sphere translating over the shutter
    (TransformTimes 0 1): a motion scene above BVH_THRESHOLD primitives,
    so the binary-BVH walk (directlighting maxdepth 5, 1 spp)."""
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    cw = ('' if crop is None else
          ' "float cropwindow" [' + " ".join(str(c) for c in crop) + ']')
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]{cw}\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            'LookAt 0 1.2 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "directlighting" "integer maxdepth" [5]\n'
            'TransformTimes 0 1\nWorldBegin\n'
            'LightSource "point" "point from" [3 6 -4] "rgb I" [60 60 60]\n'
            'AttributeBegin\nActiveTransform EndTime\nTranslate 0.3 0 0\nActiveTransform All\n'
            'Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx) + 'AttributeEnd\n'
            'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX)
            + "WorldEnd\n")


def benchlens_scene_text(res, crop=None):
    """The bench geometry scaled by BENCHLENS_SCALE with its sphere
    BENCHLENS_DIST in front of the biconvex lens (Camera "realistic",
    film at the thin-lens image distance, no AF zones) under a distant
    light; path maxdepth 5, 1 spp."""
    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    k = BENCHLENS_SCALE
    eye_y = 0.4 * k + 0.3 * BENCHLENS_DIST
    eye_z = -np.sqrt(BENCHLENS_DIST ** 2 - (eye_y - 0.4 * k) ** 2)
    film_dist = 1.0 / (LENS_INV_F - 1.0 / BENCHLENS_DIST)
    cw = '' if crop is None else ' "float cropwindow" [' + " ".join(map(str, crop)) + ']'
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]{cw}\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            f'LookAt 0 {eye_y:.4f} {eye_z:.4f}  0 {0.4 * k:.4f} 0  0 1 0\n'
            f'Camera "realistic" "string specfile" "{LENS}" "float filmdistance" '
            f'[{film_dist:.4f}] "float aperture_diameter" [8] "float filmdiag" [40]\n'
            'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
            'LightSource "distant" "point from" [2 4 -3] "point to" [0 0 0] "rgb L" [60 60 60]\n'
            f'AttributeBegin\nScale {k} {k} {k}\n'
            'Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx)
            + 'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX)
            + "AttributeEnd\nWorldEnd\n")


def benchirr_scene_text(res, crop=None):
    """The bench scene under irradiancecache, nsamples 4096 (16 gather
    rays a hit), 1 spp."""
    s = bench_scene_text(res).replace('SurfaceIntegrator "path" "integer maxdepth" [5]',
                                      'SurfaceIntegrator "irradiancecache" '
                                      '"integer nsamples" [4096]')
    if crop is not None:
        s = s.replace(f'"integer yresolution" [{res}]', f'"integer yresolution" [{res}] '
                      '"float cropwindow" [' + " ".join(map(str, crop)) + ']', 1)
    return s


LONGTAIL_DISTANT = ('LightSource "distant" "point from" [2 4 -3] "point to" [0 0 0] '
                    '"rgb L" [3 3 3]\n')
# [24]'s cases: (surface integrator line, replacement of the point light, of the matte sphere)
LONGTAIL_CASES = {
    "igi": ('SurfaceIntegrator "igi" "integer nlights" [16] "integer nsets" [2] '
            '"integer maxdepth" [3]', None, None),
    "dipolesubsurface": ('SurfaceIntegrator "dipolesubsurface" "float minsampledistance" [0.5]',
                         None, 'Material "subsurface" "string name" ["Marble"]'),
    "diffuseprt": ('SurfaceIntegrator "diffuseprt" "integer lmax" [4] "integer nsamples" [1024]',
                   LONGTAIL_DISTANT, None),
    "glossyprt": ('SurfaceIntegrator "glossyprt" "integer lmax" [4]', LONGTAIL_DISTANT, None),
}


def longtail_text(integrator, lights=None, material=None, renderer=None):
    """The small scene (SLICE_RES^2, 4 spp) under another surface
    integrator (or renderer), light or matte-sphere material."""
    s = small_variant_text(SLICE_RES, 4, lights=lights).replace(
        'SurfaceIntegrator "path" "integer maxdepth" [5]', integrator)
    if material:
        s = s.replace('Material "matte" "rgb Kd" [.6 .3 .2]', material)
    if renderer:
        s = s.replace("WorldBegin\n", renderer + "\nWorldBegin\n", 1)
    return s


def af_plane_text(res, film_dist, zones_path):
    """tests/test_realistic_camera.py's plane: a checkerboard quad at
    z = AF_OBJ under a head-on distant light, seen through the biconvex
    lens with one AF zone; path maxdepth 5, 1 spp."""
    ext = AF_OBJ * 0.8
    P = np.array([[-ext, -ext, AF_OBJ], [ext, -ext, AF_OBJ], [ext, ext, AF_OBJ],
                  [-ext, ext, AF_OBJ]], np.float32)
    return (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            f'Camera "realistic" "string specfile" "{LENS}" "float filmdistance" '
            f'[{film_dist:.5f}] "float aperture_diameter" [6] "float filmdiag" [40] '
            f'"string af_zones" "{zones_path}"\n'
            'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
            'LightSource "distant" "point from" [0 0 -10] "point to" [0 0 0] "rgb L" [6 6 6]\n'
            'Texture "checks" "color" "checkerboard" "float uscale" [24] "float vscale" [24] '
            '"rgb tex1" [.9 .9 .9] "rgb tex2" [.05 .05 .05]\n'
            'Material "matte" "texture Kd" "checks"\n'
            + mesh(P, np.array([0, 1, 2, 2, 3, 0]))[:-1] + ' "float uv" [0 0 1 0 1 1 0 1]\n'
            + "WorldEnd\n")


# ---------------------------------------------------------------------------
# Timing and comparison

def cuda_ms(fn, iters=5, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    """-> (least ms for the work on the card, what sets it)."""
    f, b = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f, "operations") if f >= b else (b, "bytes")


SASS_CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FADD32I", "FMUL32I", "FFMA32I"},
    "mufu": {"MUFU"},
    "cmp_sel": {"FSETP", "FSEL", "SEL", "ISETP", "PLOP3", "FCHK", "FMNMX", "IMNMX", "P2R", "R2P"},
    "lds": {"LDS", "LDSM"},
}


def sass_inner_loops(lib_path):
    """Instruction counts of each kernel's inner loop, from `cuobjdump
    -sass` of the built library: for every function, the innermost
    backward-branch loop that holds MUFU.RCP (one per Moller-Trumbore
    test). -> {function: {"tests", "instructions", "per_test", "by_class",
    "slow_path", "per_test_fast", "ceiling"}}. "slow_path" counts the
    lines that call the division's slow path (from the branch over them
    to the branch back), which run only for a det outside the
    reciprocal's fast range (zero, denormal, >= 2^126); "per_test_fast"
    leaves them out. ceiling = MT_FLOPS / (2 x per_test_fast), the share
    of the FLOP bound that issuing one instruction per scheduler per
    cycle allows. {} without cuobjdump."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(exe):
        return {}
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                         timeout=120).stdout
    funcs, labels, cur, pending = {}, {}, None, []
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur], labels[cur], pending = [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m and cur:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[cur][lab] = addr
            pending = []
            funcs[cur].append((addr, m.group(2)))
    result = {}
    for name, ins in funcs.items():
        ops = []
        for addr, text in ins:
            words = text.split()
            if words and words[0].startswith("@"):
                words = words[1:]
            ops.append((addr, words[0].split(".")[0] if words else "", text))
        loops = []
        for addr, op, text in ops:
            if op != "BRA":
                continue
            m = re.search(r"\(?(\.L_x_\d+)\)?|0x([0-9a-f]+)", text.split("BRA", 1)[1])
            if not m:
                continue
            target = labels[name].get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            if target is not None and target < addr:
                body = [o for a, o, _ in ops if target <= a <= addr]
                rcp = sum(1 for a, o, t in ops if target <= a <= addr and "MUFU.RCP" in t)
                if rcp:
                    loops.append((target, addr, body, rcp))
        inner = [lp for lp in loops
                 if not any(o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        if not inner:
            continue
        start, end, body, rcp = max(inner, key=lambda lp: lp[3])
        texts = [t for a, _, t in ops if start <= a <= end]
        slow = 0
        for c, t in enumerate(texts):
            if "CALL" not in t:
                continue
            b = max((i for i in range(c) if "BRA" in texts[i] and texts[i].startswith("@")),
                    default=c - 1)
            e = next((i for i in range(c + 1, len(texts))
                      if "BRA" in texts[i] and not texts[i].startswith("@")), c)
            slow += e - b
        by_class = {c: sum(1 for o in body if o in names) for c, names in SASS_CLASSES.items()}
        by_class["other"] = len(body) - sum(by_class.values())
        fast = (len(body) - slow) / rcp
        result[name] = {"tests": rcp, "instructions": len(body), "per_test": len(body) / rcp,
                        "by_class": by_class, "slow_path": slow, "per_test_fast": fast,
                        "ceiling": MT_FLOPS / (2 * fast)}
    return result


def sass_of(sass, *kernels):
    """The inner-loop counts of the first function whose (mangled) name
    holds one of `kernels`, or None."""
    for k in kernels:
        for fn, c in sass.items():
            if k in fn:
                return c
    return None


def compare(name, t, p, t_ref, p_ref, bits=False):
    """prim identical, t within T_RTOL relative on hits (bits=True: t
    bit-equal on every ray) -> max |dt|."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(p.long(), p_ref.long()):
        bad = int((p.long() != p_ref.long()).sum())
        raise RuntimeError(f"{name}: prim differs on {bad} of {p.numel()} rays")
    differ = int((t.view(torch.int32) != t_ref.view(torch.int32)).sum())
    if bits and differ:
        raise RuntimeError(f"{name}: t bits differ on {differ} of {t.numel()} rays")
    hit = p_ref >= 0
    err = (t[hit] - t_ref[hit]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if err.numel() and bool((err > T_RTOL * t_ref[hit].abs()).any()):
        raise RuntimeError(f"{name}: t differs beyond {T_RTOL} relative (max {max_err})")
    log(f"  {name}: {int(hit.sum())}/{p.numel()} hits, prim identical, "
        f"{'t bit-equal' if bits else f'max |dt| = {max_err:.3g}'}")
    return max_err


def random_rays(n, seed, device):
    """Random rays with dead lanes and a short tmax mixed in."""
    import torch

    rng = np.random.RandomState(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    tmax[: n // 8] = -1.0
    tmax[n // 8: n // 4] = 2.0
    return tuple(torch.as_tensor(x, device=device)
                 for x in (o, d, np.zeros(n, np.float32), tmax))


# ---------------------------------------------------------------------------
# Phases

def phase_k1(device):
    """K1 vs its plain version: 4096 random triangles, 65536 rays."""
    import torch
    from pbrt_tpu_torch.ops import intersect_cuda as k1

    rng = np.random.RandomState(1)
    c = rng.uniform(-5, 5, (4096, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (4096, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (4096, 3)).astype(np.float32)
    soa = k1.TriSoA(*(torch.as_tensor(x, device=device) for x in (c - (e1 + e2) / 3, e1, e2)))
    rays8 = k1.make_rays8(*random_rays(65536, 2, device))
    t, p = k1.tri_t_pass_cuda(rays8, soa.tris9, soa.n)
    t_ref, p_ref = k1.tri_t_pass_plain(rays8, soa.tris9, soa.n)
    err = compare("K1 vs plain (65536 rays x 4096 tris)", t, p, t_ref, p_ref, bits=True)
    ms = cuda_ms(lambda: k1.tri_t_pass_cuda(rays8, soa.tris9, soa.n), iters=20)
    plain_ms = cuda_ms(lambda: k1.tri_t_pass_plain(rays8, soa.tris9, soa.n), iters=3)
    live = int((rays8[:, 6] < rays8[:, 7]).sum())
    nbytes = rays8.numel() * 4 + soa.tris9.numel() * 4 + 65536 * 8
    b_ms, b_by = bound(live * soa.n * MT_FLOPS, nbytes)
    all_ms, _ = bound(65536 * soa.n * MT_FLOPS, nbytes)
    log(f"  K1 time: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms; live rays "
        f"{live / 65536:.4f}; bound {b_ms:.4f} ms over live rays ({b_by}), {b_ms / ms:.1%} "
        f"of bound; over all rays {all_ms:.4f} ms, {all_ms / ms:.1%}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_all_rays_ms": all_ms, "live_share": live / 65536,
            "tests": live * soa.n}


class SweepRecorder:
    """Stands in for bvh_cuda.wide_sweep during the K2 comparison: every
    wave's pair list goes through the plain version (on a copy of the
    accumulators) and the kernel, which must agree; both are timed, and
    each wave's bound is computed from its pair list."""

    def __init__(self, bvh_cuda):
        self.m = bvh_cuda
        self.ms = self.plain_ms = self.max_err = 0.0
        self.waves = self.pairs = self.t_bits_differ = self.max_per_tile = 0
        self.flops_ms = self.bytes_ms = self.bound_ms = self.mean_per_tile = 0.0

    def __call__(self, pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc):
        import torch

        t_ref, p_ref = t_acc.clone(), p_acc.clone()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        self.m.wide_sweep_plain(pair_block, start, count, rays8, tris16, sentinel, t_ref, p_ref)
        ev[1].record()
        torch.cuda._sleep(1_000_000)  # keeps the device busy while the wrapper enqueues
        ev[2].record()
        self.m.wide_sweep_cuda(pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc)
        ev[3].record()
        torch.cuda.synchronize()
        self.plain_ms += ev[0].elapsed_time(ev[1])
        self.ms += ev[2].elapsed_time(ev[3])
        self.waves += 1
        n = int(count.sum())
        blocks = pair_block[:n]
        real = blocks[blocks != sentinel]
        self.pairs += int(real.numel())
        self.max_per_tile = max(self.max_per_tile, int(count.max()))
        self.mean_per_tile += n / count.numel()
        tests = int(real.numel()) * 1024 * 128
        nbytes = (int(torch.unique(real).numel()) * 9 * 128 * 4       # leaf blocks named
                  + int((count > 0).sum()) * 1024 * (32 + 2 * 8)      # rays, t/prim in and out
                  + n * 4 + count.numel() * 8)                        # the pair list
        f_ms, b_ms = tests * MT_FLOPS / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        self.flops_ms += f_ms
        self.bytes_ms += b_ms
        self.bound_ms += max(f_ms, b_ms)
        self.t_bits_differ += int((t_acc.view(torch.int32) != t_ref.view(torch.int32)).sum())
        if not torch.equal(p_acc, p_ref):
            raise RuntimeError(f"K2 wave {self.waves}: prim differs on "
                               f"{int((p_acc != p_ref).sum())} rays")
        live = p_ref >= 0
        err = (t_acc[live] - t_ref[live]).abs()
        if err.numel():
            if bool((err > T_RTOL * t_ref[live].abs()).any()):
                raise RuntimeError(f"K2 wave {self.waves}: t differs beyond {T_RTOL}")
            self.max_err = max(self.max_err, float(err.max()))
        return t_acc, p_acc


    def summary(self):
        return {"waves": self.waves, "pairs": self.pairs, "ms": self.ms,
                "plain_ms": self.plain_ms, "bound_ms": self.bound_ms,
                "bound_by": "operations" if self.flops_ms >= self.bytes_ms else "bytes",
                "max_pairs_per_tile": self.max_per_tile,
                "mean_pairs_per_tile": self.mean_per_tile / max(self.waves, 1),
                "max_abs_err": self.max_err, "t_bits_differ": self.t_bits_differ}


class LaunchTimer:
    """Stands in for a kernel's wrapper in a render: CUDA events around
    each launch, read after the render (no sync during it). An event pair
    spans from the wrapper's call to the kernel's end, so it also holds
    the wrapper's host time whenever the device waits on the host.
    `work(*args)`, if given, describes the launch's work as (a device
    tensor, enqueued after the second event and read after the render;
    a tuple of host ints)."""

    def __init__(self, fn, work=None):
        self.fn, self.work = fn, work
        self.events, self.works = [], []

    def __call__(self, *args, **kw):
        import torch

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = self.fn(*args, **kw)
        b.record()
        self.events.append((a, b))
        if self.work is not None:
            self.works.append(self.work(*args))
        return out

    def total_ms(self):
        import torch

        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events)

    def work_rows(self):
        """Each launch's work as a list of ints (after the render)."""
        import torch

        torch.cuda.synchronize()
        return [[int(x) for x in dev.tolist()] + list(host) for dev, host in self.works]


def k2_work(pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc):
    """One K2 launch's work without a sync: (real pairs, distinct leaf
    blocks, tiles with pairs, listed pairs) on the device; (tiles,)."""
    import torch

    n = count.sum()
    real = (torch.arange(pair_block.numel(), device=count.device) < n) & (pair_block != sentinel)
    seen = torch.zeros(sentinel + 1, dtype=torch.int64, device=count.device)
    seen.scatter_(0, torch.where(real, pair_block, sentinel).long(), 1)
    return (torch.stack([real.sum(), seen[:sentinel].sum(), (count > 0).sum(), n.long()]),
            (count.numel(),))


def k2_launch_bound(pairs, blocks, tiles, listed, n_tiles):
    """(flops ms, bytes ms) of one K2 launch, counted as SweepRecorder does."""
    nbytes = blocks * 9 * 128 * 4 + tiles * 1024 * (32 + 2 * 8) + listed * 4 + n_tiles * 8
    return pairs * 1024 * 128 * MT_FLOPS / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3


class K1Recorder:
    """Stands in for intersect_cuda.tri_t_pass_cuda during a render: every
    launch also goes through the plain twin on the same inputs, which must
    agree bit for bit; both are timed by CUDA events (the device kept busy
    while the wrapper enqueues), and each launch's live-ray share and
    bound are recorded."""

    def __init__(self, kernel, plain):
        self.kernel, self.plain = kernel, plain
        self.ms = self.plain_ms = self.flops_ms = self.bytes_ms = self.all_flops_ms = 0.0
        self.launches = self.rays = self.live = self.hits = self.tests = 0
        self.live_shares, self.rays_per_launch = [], []

    def __call__(self, rays8, tris9, n_tris):
        import torch

        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        t_ref, p_ref = self.plain(rays8, tris9, n_tris)
        ev[1].record()
        torch.cuda._sleep(1_000_000)  # keeps the device busy while the wrapper enqueues
        ev[2].record()
        t, p = self.kernel(rays8, tris9, n_tris)
        ev[3].record()
        self.launches += 1
        bad_p = int((p != p_ref).sum())
        bad_t = int((t.view(torch.int32) != t_ref.view(torch.int32)).sum())
        if bad_p or bad_t:
            raise RuntimeError(f"K1 render launch {self.launches}: prim differs on {bad_p} "
                               f"rays, t bits on {bad_t}")
        self.plain_ms += ev[0].elapsed_time(ev[1])
        self.ms += ev[2].elapsed_time(ev[3])
        R = rays8.shape[0]
        live = int((rays8[:, 6] < rays8[:, 7]).sum())
        self.rays += R
        self.live += live
        self.tests += live * n_tris
        self.hits += int((p >= 0).sum())
        self.live_shares.append(live / max(R, 1))
        self.rays_per_launch.append(R)
        self.flops_ms += live * n_tris * MT_FLOPS / PEAK_F32 * 1e3
        self.all_flops_ms += R * n_tris * MT_FLOPS / PEAK_F32 * 1e3
        self.bytes_ms += (rays8.numel() * 4 + tris9.numel() * 4 + R * 8) / PEAK_BYTES * 1e3
        return t, p

    def summary(self):
        return {"launches": self.launches, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": max(self.flops_ms, self.bytes_ms),
                "bound_by": "operations" if self.flops_ms >= self.bytes_ms else "bytes",
                "bound_all_rays_ms": max(self.all_flops_ms, self.bytes_ms),
                "live_share": self.live / max(self.rays, 1),
                "live_share_per_launch": [round(x, 4) for x in self.live_shares],
                "rays_per_launch": self.rays_per_launch, "tests": self.tests,
                "rays": self.rays, "hits": self.hits}


def traverse(bvh_cuda, wb, o, d, tmin, tmax, per, **kw):
    """wide_t_pass over the rays in traversals of `per` rays, every wave
    held against the plain version -> (SweepRecorder, t, prim)."""
    import torch

    rec = SweepRecorder(bvh_cuda)
    real_sweep = bvh_cuda.wide_sweep
    try:
        bvh_cuda.wide_sweep = rec
        out = [bvh_cuda.wide_t_pass(wb, o[s:s + per], d[s:s + per], tmin[s:s + per],
                                    tmax[s:s + per], **kw)
               for s in range(0, o.shape[0], per)]
    finally:
        bvh_cuda.wide_sweep = real_sweep
    return rec, torch.cat([t for t, _ in out]), torch.cat([p for _, p in out])


def phase_k2(device):
    """K2 vs its plain version on the same pair lists (every wave), at
    the bench geometry, for camera, shadow (any-hit) and incoherent
    rays, each traversed whole (1M rays) and in the render's 65,536-ray
    traversals; then wide_t_pass vs plain brute force on an 8192-ray
    subset."""
    import torch
    from pbrt_tpu_torch.accel.bvh import build_bvh
    from pbrt_tpu_torch.accel.intersect import SceneGeom, t_pass_brute
    from pbrt_tpu_torch.accel.wide_bvh import build_wide_bvh
    from pbrt_tpu_torch.core.geometry import Ray
    from pbrt_tpu_torch.ops import bvh_cuda

    v0, e1, e2 = bench_geometry()
    t0 = time.perf_counter()
    wb = build_wide_bvh(build_bvh(v0, e1, e2, "sah"), v0, e1, e2, device)
    log(f"  bench geometry: {len(v0)} tris -> {wb.n_blocks} leaf blocks "
        f"(host build {time.perf_counter() - t0:.2f} s)")

    n = BENCH_RES * BENCH_RES
    xs = np.linspace(-0.55, 0.55, BENCH_RES, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs[::-1], indexing="xy")
    d = np.stack([gx.ravel(), gy.ravel() + 0.18, np.ones(n, np.float32)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cam_o = torch.as_tensor(np.tile([[0.0, 1.2, -4.0]], (n, 1)).astype(np.float32), device=device)
    cam_d = torch.as_tensor(d, device=device)
    zeros = torch.zeros(n, device=device)
    inf = torch.full((n,), float("inf"), device=device)

    results = {}
    for per in (n, RENDER_RAYS):
        rec, t_cam, p_cam = traverse(bvh_cuda, wb, cam_o, cam_d, zeros, inf, per,
                                     coherent=True)
        results[("camera", per)] = rec
        if per == n:
            # shadow rays from the primary hits toward a light (bench.py)
            hit_p = cam_o + torch.where(p_cam >= 0, t_cam, 0.0)[:, None] * cam_d
            sd = torch.tensor([0.0, 6.0, 0.0], device=device)[None, :] - hit_p
            sdist = torch.sqrt(torch.sum(sd * sd, -1))
            sdir = sd / torch.clamp(sdist, min=1e-9)[:, None]
            s_o = hit_p + sdir * 1e-3
            s_tmax = torch.where(p_cam >= 0, sdist * 0.999, -1.0)
            rng = np.random.RandomState(0)
            i_o = torch.as_tensor(rng.rand(n, 3).astype(np.float32) * 6 - 3, device=device)
            i_d = rng.randn(n, 3).astype(np.float32)
            i_d = torch.as_tensor(i_d / np.linalg.norm(i_d, axis=-1, keepdims=True),
                                  device=device)
        results[("shadow", per)], _, _ = traverse(bvh_cuda, wb, s_o, sdir, zeros, s_tmax, per,
                                                  any_hit=True, coherent=True)
        results[("incoherent", per)], _, _ = traverse(bvh_cuda, wb, i_o, i_d, zeros, inf, per)
    for (name, per), r in results.items():
        m = r.summary()
        log(f"  K2 {name} rays ({n}, traversals of {per}): {m['waves']} waves, {m['pairs']} "
            f"(tile, block) pairs, per tile per wave max {m['max_pairs_per_tile']} mean "
            f"{m['mean_pairs_per_tile']:.3f}; kernel {m['ms']:.3f} ms, plain torch "
            f"{m['plain_ms']:.3f} ms, bound {m['bound_ms']:.3f} ms ({m['bound_by']}), "
            f"{m['bound_ms'] / m['ms']:.1%} of bound; prim identical, max |dt| = "
            f"{m['max_abs_err']:.3g}, rays with t bits differing {m['t_bits_differ']}")

    # wide_t_pass (kernel) vs plain brute force on a subset
    geom_cols = [torch.as_tensor(x, device=device) for x in (v0, e1, e2)]
    k = 8192
    sub = torch.as_tensor(np.random.RandomState(4).choice(n, k, replace=False), device=device)
    for name, o_, d_ in (("camera", cam_o, cam_d), ("incoherent", i_o, i_d)):
        o_s, d_s = o_[sub].contiguous(), d_[sub].contiguous()
        t_w, p_w = bvh_cuda.wide_t_pass(wb, o_s, d_s, zeros[:k], inf[:k],
                                        coherent=name == "camera")
        geom = SceneGeom(*geom_cols, None, None, None, None, None, None, None, None)
        t_b, p_b = t_pass_brute(geom, Ray(o_s, d_s, zeros[:k], inf[:k], zeros[:k]))
        compare(f"wide_t_pass vs plain brute force ({name}, {k} rays)", t_w, p_w, t_b, p_b)
    by_set = {f"{name}_{per}": r.summary() for (name, per), r in results.items()}
    render = [r.summary() for (_, per), r in results.items() if per == RENDER_RAYS]
    f_ms = sum(r.flops_ms for (_, per), r in results.items() if per == RENDER_RAYS)
    b_ms = sum(r.bytes_ms for (_, per), r in results.items() if per == RENDER_RAYS)
    pairs = sum(m["pairs"] for m in render)
    return {"max_abs_err": max(r.max_err for r in results.values()),
            "ms": sum(m["ms"] for m in render), "plain_ms": sum(m["plain_ms"] for m in render),
            "bound_ms": sum(m["bound_ms"] for m in render),
            "bound_by": "operations" if f_ms >= b_ms else "bytes",
            "pairs": pairs, "tests": pairs * 1024 * 128, "by_set": by_set}


def profile_render(scene_text, tmp):
    """One render under torch.profiler: device busy share and K2's share
    of device time (kernel rows only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(scene_text, "bench_profiled", tmp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    averages = prof.key_averages()
    rows = sorted(((e.key, dev_us(e), e.count) for e in averages
                   if e.device_type == DeviceType.CUDA and dev_us(e) > 0),
                  key=lambda r: -r[1])
    busy_ms = sum(us for _, us, _ in rows) / 1e3
    # wide_sweep_kernel: K2's one-kernel form, for A/B runs against older trees
    k2_rows = [r for r in rows if "k2_" in r[0] or "wide_sweep" in r[0]]
    k2_ms = sum(us for _, us, _ in k2_rows) / 1e3
    n_dev = sum(c for _, _, c in rows)
    log(f"  wall {wall:.3f} s, device busy {busy_ms:.1f} ms ({busy_ms / 1e3 / wall:.3f} of "
        f"wall) over {n_dev} device operations, K2 kernels {k2_ms:.1f} ms "
        f"({k2_ms / max(busy_ms, 1e-9):.3f} of device time)")
    for key, us, cnt in rows[:10]:
        log(f"    {us / 1e3:10.2f} ms  {cnt:7d} x  {key[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total, e.count) for e in averages
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    log("  host, by self time:")
    for key, us, cnt in host[:8]:
        log(f"    {us / 1e3:10.2f} ms  {cnt:7d} x  {key[:90]}")
    return {"wall_s": wall, "device_busy_ms": busy_ms, "device_ops": n_dev, "k2_ms": k2_ms,
            "k2_rows": [[k[:60], us / 1e3, c] for k, us, c in k2_rows]}


def agree(gpu, cpu, what):
    """[7]'s limits between a card render and a CPU render of one scene:
    image mean within 0.5%, 99% of pixels within 1e-3 relative."""
    rel = (np.abs(gpu - cpu) / np.maximum(np.abs(cpu), 1e-6)).max(-1)
    mean_rel = float(abs(gpu.mean() - cpu.mean()) / cpu.mean())
    within = float((rel <= 1e-3).mean())
    log(f"  {what}: card vs CPU mean rel diff {mean_rel:.3g}, pixels within 1e-3: {within:.4f}")
    if mean_rel > 5e-3 or within < 0.99:
        raise RuntimeError(f"{what}: card render disagrees with the CPU render")
    return mean_rel, within


def k2_spans(k2):
    """Event spans, launches, pairs and bound of a LaunchTimer(K2, k2_work)."""
    work = k2.work_rows()
    return {"k2_ms": k2.total_ms(), "k2_launches": len(k2.events),
            "k2_pairs": sum(w[0] for w in work),
            "k2_bound_ms": sum(max(f, b) for f, b in (k2_launch_bound(*w) for w in work))}


def crop_check(text_fn, res, crop, img, name, tmp):
    """The crop of a card render against the same crop rendered on the
    CPU in one tile of exactly its samples -> (CPU s, mean rel, within)."""
    x0, x1, y0, y1 = (int(np.ceil(res * c)) for c in crop)
    cpu, cpu_sec = render(text_fn(res, crop), name + "_crop_cpu", tmp,
                          extra=("--device", "cpu", "--tile-samples", str((x1 - x0) * (y1 - y0))))
    mean_rel, within = agree(img[y0:y1, x0:x1], cpu,
                             f"crop {x1 - x0}x{y1 - y0} ({cpu_sec:.2f} s on the CPU)")
    return cpu_sec, mean_rel, within


class NoPlain:
    """While active, the plain twins of K1 and K2 and the triangle brute
    force raise: a render on the card must not reach them."""

    def __enter__(self):
        from pbrt_tpu_torch.accel import intersect
        from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

        def refuse(*args, **kw):
            raise RuntimeError("a plain twin ran on the card's main path")

        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (intersect_cuda, "tri_t_pass_plain"), (bvh_cuda, "wide_sweep_plain"),
            (intersect, "t_pass_brute"))]
        for m, n, _ in self.saved:
            setattr(m, n, refuse)
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


class Patched:
    """Replaces module attributes for the length of a with block."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.triples]
        for m, n, f in self.triples:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def eager_path_loop():
    """(module, name, value) for Patched: li_path (and the photon shoot)
    run their stretches eagerly, through the one rule for where they
    replay, so that events around a function they call time each call
    (a CUDA graph replays the function's kernels without calling it)."""
    from pbrt_tpu_torch.core import graphs

    return graphs, "graphs_for", lambda *args: graphs.EAGER


class AnyHitCounter:
    """Stands in for bvh_cuda.wide_t_pass: counts the K2 launches of
    closest-hit and of any-hit traversals."""

    def __init__(self, bvh_cuda):
        self.m, self.fn = bvh_cuda, bvh_cuda.wide_t_pass
        self.any_hit = self.closest = 0

    def __call__(self, *args, any_hit=False, **kw):
        before = self.m.launches
        out = self.fn(*args, any_hit=any_hit, **kw)
        if any_hit:
            self.any_hit += self.m.launches - before
        else:
            self.closest += self.m.launches - before
        return out


def phase_goldens(tmp, names=GOLDENS_MAIN):
    """[9] and [23]: the reference-binary goldens `names` through the CLI
    on the card at their authored size and spp, against the reference
    images and the CPU render; every K1 launch of the scenes with
    triangles held bit for bit against the plain twin in a second render.
    -> per scene dict."""
    from pbrt_tpu_torch.io.image import read_image
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    out = {}
    for name, mean_rtol, pix_bound in (g for g in GOLDENS if g[0] in names):
        with open(os.path.join(GOLDEN_DIR, f"{name}.pbrt")) as f:
            text = f.read()
        ref = np.asarray(read_image(os.path.join(GOLDEN_DIR, f"ref_{name}.pfm")))
        intersect_cuda.launches = 0
        bvh_cuda.launches = 0
        with NoPlain():
            img, sec = render(text, f"golden_{name}", tmp)
        k1_launches, k2_launches = intersect_cuda.launches, bvh_cuda.launches
        level = max(float(ref.mean()), 1e-6)
        mean_ratio = float(img.mean()) / level
        mad_ratio = float(np.abs(img - ref).mean()) / level
        ok = img.shape == ref.shape and abs(mean_ratio - 1) < mean_rtol and mad_ratio < pix_bound
        log(f"  {name} {img.shape[1]}x{img.shape[0]}: {sec:.2f} s, K1 launches {k1_launches}, "
            f"K2 launches {k2_launches}; vs reference binary: mean level ratio "
            f"{mean_ratio:.4f} (bound |1 - r| < {mean_rtol}), mean abs diff / level "
            f"{mad_ratio:.4f} (bound {pix_bound}): {'pass' if ok else 'FAIL'}")
        if not ok:
            raise RuntimeError(f"golden {name} outside the reference-binary bounds")
        cpu, cpu_sec = render(text, f"golden_{name}_cpu", tmp, extra=("--device", "cpu"))
        mean_rel, within = agree(img, cpu, f"{name} ({cpu_sec:.2f} s on the CPU)")
        row = {"seconds": sec, "k1_launches": k1_launches, "k2_launches": k2_launches,
               "mean_ratio": mean_ratio, "mad_ratio": mad_ratio, "bounds": [mean_rtol, pix_bound],
               "pass": ok, "cpu_mean_rel": mean_rel, "cpu_within_1e-3": within}
        if k1_launches:
            log(f"  {name}:")
            row["k1"] = checked_card_render(text, f"golden_{name}_checked", tmp,
                                            expect=k1_launches)[1]
        out[name] = row
    return out


def phase_benchvol(tmp):
    """[10]: benchvol through the CLI on the card (timed), again with
    CUDA events around every quadric fold, volume march and K2 launch,
    then at BENCHVOL_CHECK_RES^2 on the card and the CPU. -> dict."""
    from pbrt_tpu_torch.accel import bvh as bvh_mod
    from pbrt_tpu_torch.integrators import volume as vol_int
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    res = BENCHVOL_RES
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain():
        img, sec = render(benchvol_scene_text(res), "benchvol", tmp)
    k2_launches, k1_launches = bvh_cuda.launches, intersect_cuda.launches
    log(f"  {res}x{res}, 1 spp: {sec:.2f} s end to end (parse + compile + BVH build + render), "
        f"{res * res / sec:.0f} camera rays/s, image mean {img.mean():.5f}, K2 launches "
        f"{k2_launches}, K1 launches {k1_launches}")
    if k2_launches <= 0:
        raise RuntimeError("benchvol render did not launch K2")

    quad = LaunchTimer(bvh_mod.quad_t_pass)
    march = LaunchTimer(vol_int.li_single)
    k2 = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
    kinds = AnyHitCounter(bvh_cuda)
    bvh_cuda.launches = 0
    with NoPlain(), Patched((bvh_mod, "quad_t_pass", quad), (vol_int, "li_single", march),
                            (bvh_cuda, "wide_sweep", k2), (bvh_cuda, "wide_t_pass", kinds)):
        _, sec_ev = render(benchvol_scene_text(res), "benchvol_events", tmp)
    if bvh_cuda.launches != k2_launches:
        raise RuntimeError(f"benchvol: K2 launches differ between renders: "
                           f"{bvh_cuda.launches} vs {k2_launches}")
    work = k2.work_rows()
    per_launch = [k2_launch_bound(*w) for w in work]
    spans = {"quad_t_pass_ms": quad.total_ms(), "quad_t_pass_calls": len(quad.events),
             "li_single_ms": march.total_ms(), "li_single_calls": len(march.events),
             "k2_ms": k2.total_ms(), "k2_launches": len(k2.events),
             "k2_pairs": sum(w[0] for w in work),
             "k2_bound_ms": sum(max(f, b) for f, b in per_launch)}
    log(f"  again with events: {sec_ev:.2f} s end to end; K2 launches {k2_launches} "
        f"({kinds.any_hit} any-hit, {kinds.closest} closest-hit); event spans: quadric fold "
        f"{spans['quad_t_pass_ms']:.1f} ms over {spans['quad_t_pass_calls']} calls, volume "
        f"march (li_single, shadow traversals included) {spans['li_single_ms']:.1f} ms over "
        f"{spans['li_single_calls']} calls, K2 {spans['k2_ms']:.1f} ms over "
        f"{spans['k2_launches']} launches ({spans['k2_pairs']} (tile, block) pairs, bound "
        f"{spans['k2_bound_ms']:.3f} ms)")
    # the CPU traces the wide pipeline in plain torch, one pair step at a
    # time (145 s at 32^2 on the H100's host, 96 s at 16^2): 16^2, in one
    # tile of exactly its camera rays (a larger tile would pad it with
    # copies of the last pixel's rays, which the CPU would trace too)
    res_check = BENCHVOL_CHECK_RES
    text = benchvol_scene_text(res_check)
    tile = ("--tile-samples", str(res_check * res_check))
    gpu, _ = render(text, "benchvol_check_gpu", tmp, extra=tile)
    cpu, cpu_sec = render(text, "benchvol_check_cpu", tmp, extra=(*tile, "--device", "cpu"))
    mean_rel, within = agree(gpu, cpu, f"benchvol {res_check}x{res_check} ({cpu_sec:.2f} s "
                             f"on the CPU)")
    return {"res": res, "seconds": sec, "camera_rays_per_s": res * res / sec,
            "seconds_with_events": sec_ev, "k2_launches": k2_launches,
            "k2_any_hit_launches": kinds.any_hit, "k2_closest_launches": kinds.closest,
            "k1_launches": k1_launches, "spans": spans, "check_res": res_check,
            "cpu_seconds": cpu_sec, "cpu_mean_rel": mean_rel, "cpu_within_1e-3": within}


def phase_rainbowc(tmp):
    """[11]: the exact rainbowc (tests/goldens/rainbowc.pbrt: its walls'
    imagemap x scale texture over the missing lines.tga, a white texel)
    through the CLI on the card at its authored size (photonmap with
    final gather, photonvolume in a rainbow region under a distant
    light), held to the reference binary's bounds RAINBOWC_BOUNDS; every
    K1 launch held bit for bit against the plain twin in a second
    render; then a 24^2 crop on the card and on the CPU. -> dict."""
    from pbrt_tpu_torch.io.image import read_image
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    text = rainbowc_text()
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain():
        img, sec = render(text, "rainbowc", tmp)
    k1_launches, k2_launches = intersect_cuda.launches, bvh_cuda.launches
    ref = np.asarray(read_image(os.path.join(GOLDEN_DIR, "ref_rainbowc.pfm")))
    level = max(float(ref.mean()), 1e-6)
    mean_ratio = float(img.mean()) / level
    mad_ratio = float(np.abs(img - ref).mean()) / level
    mean_rtol, pix_bound = RAINBOWC_BOUNDS
    ok = img.shape == ref.shape and abs(mean_ratio - 1) < mean_rtol and mad_ratio < pix_bound
    log(f"  {img.shape[1]}x{img.shape[0]}: {sec:.2f} s, K1 launches {k1_launches}, K2 launches "
        f"{k2_launches}; vs the reference binary: mean level ratio {mean_ratio:.4f} (bound "
        f"|1 - r| < {mean_rtol}), mean abs diff / level {mad_ratio:.4f} (bound {pix_bound}): "
        f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("rainbowc outside the reference-binary bounds")
    if k1_launches <= 0:
        raise RuntimeError("rainbowc did not launch K1")
    r = checked_card_render(text, "rainbowc_checked", tmp, expect=k1_launches)[1]
    r.pop("live_share_per_launch")
    r.pop("rays_per_launch")
    crop = rainbowc_text(crop=RAINBOWC_CROP)
    tile = ("--tile-samples", str(24 * 24 * 2))   # one tile of exactly the crop's samples
    gpu, _ = render(crop, "rainbowc_crop_gpu", tmp, extra=tile)
    cpu, cpu_sec = render(crop, "rainbowc_crop_cpu", tmp, extra=(*tile, "--device", "cpu"))
    mean_rel, within = agree(gpu, cpu, f"rainbowc 24x24 crop ({cpu_sec:.2f} s on the CPU)")
    return {"seconds": sec, "k1_launches": k1_launches, "k2_launches": k2_launches,
            "mean_ratio": mean_ratio, "mad_ratio": mad_ratio, "bounds": list(RAINBOWC_BOUNDS),
            "pass": ok, "k1": r, "cpu_seconds": cpu_sec, "cpu_mean_rel": mean_rel,
            "cpu_within_1e-3": within}


def phase_benchtex(tmp):
    """[14]: benchtex through the CLI on the card (timed), then again,
    its path loop eager, with CUDA events around every K2 launch and
    around every eval_bsdf_params and eval_bump call (the texture and
    material evaluation) -> dict."""
    from pbrt_tpu_torch.io.image import write_image
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda
    from pbrt_tpu_torch.scene import compile as compile_mod

    res = BENCHTEX_RES
    img_path = os.path.join(tmp, "benchtex_floor.pfm")
    write_image(img_path, benchtex_image())
    text = benchtex_scene_text(res, img_path)
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain():
        img, sec = render(text, "benchtex", tmp)
    k2_launches, k1_launches = bvh_cuda.launches, intersect_cuda.launches
    log(f"  {res}x{res}, 1 spp: {sec:.2f} s end to end (parse + compile + BVH build + render), "
        f"{res * res / sec:.0f} camera rays/s, image mean {img.mean():.5f}, K2 launches "
        f"{k2_launches}, K1 launches {k1_launches}")
    if k2_launches <= 0:
        raise RuntimeError("benchtex render did not launch K2")

    k2 = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
    params = LaunchTimer(compile_mod.eval_bsdf_params)
    bump = LaunchTimer(compile_mod.eval_bump)
    bvh_cuda.launches = 0
    with NoPlain(), Patched((bvh_cuda, "wide_sweep", k2),
                            (compile_mod, "eval_bsdf_params", params),
                            (compile_mod, "eval_bump", bump), eager_path_loop()):
        _, sec_ev = render(text, "benchtex_events", tmp)
    if bvh_cuda.launches != k2_launches:
        raise RuntimeError(f"benchtex: K2 launches differ between renders: "
                           f"{bvh_cuda.launches} vs {k2_launches}")
    spans = {"eval_bsdf_params_ms": params.total_ms(), "eval_bsdf_params_calls": len(params.events),
             "eval_bump_ms": bump.total_ms(), "eval_bump_calls": len(bump.events), **k2_spans(k2)}
    tex_ms = spans["eval_bsdf_params_ms"] + spans["eval_bump_ms"]
    log(f"  again with events: {sec_ev:.2f} s end to end; event spans: eval_bsdf_params "
        f"{spans['eval_bsdf_params_ms']:.1f} ms over {spans['eval_bsdf_params_calls']} calls, "
        f"eval_bump {spans['eval_bump_ms']:.1f} ms over {spans['eval_bump_calls']} calls "
        f"(together {tex_ms / 1e3 / sec_ev:.3f} of the render), K2 {spans['k2_ms']:.1f} ms over "
        f"{spans['k2_launches']} launches ({spans['k2_pairs']} (tile, block) pairs, bound "
        f"{spans['k2_bound_ms']:.3f} ms)")
    return {"res": res, "seconds": sec, "camera_rays_per_s": res * res / sec,
            "seconds_with_events": sec_ev, "k2_launches": k2_launches,
            "k1_launches": k1_launches, "image_mean": float(img.mean()), "spans": spans,
            "texture_share": tex_ms / 1e3 / sec_ev}


def phase_smalltex(tmp):
    """[15]: the small textured scene at SMALLTEX_RES^2, 4 spp on the card
    and on the CPU (agree()'s limits), then on the card again with every
    K1 launch held bit for bit against the plain twin. -> dict."""
    from pbrt_tpu_torch.io.image import write_image
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    merl = os.path.join(tmp, "const.binary")
    write_const_merl(merl)
    img_path = os.path.join(tmp, "smalltex.pfm")
    write_image(img_path, benchtex_image()[::16, ::16])
    text = smalltex_scene_text(SMALLTEX_RES, 4, img_path, merl)
    tile = ("--tile-samples", str(SMALLTEX_RES * SMALLTEX_RES * 4))
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain():
        gpu, sec = render(text, "smalltex_gpu", tmp, extra=tile)
    k1_launches = intersect_cuda.launches
    if k1_launches <= 0:
        raise RuntimeError("smalltex render did not launch K1")
    cpu, cpu_sec = render(text, "smalltex_cpu", tmp, extra=(*tile, "--device", "cpu"))
    mean_rel, within = agree(gpu, cpu, f"smalltex {SMALLTEX_RES}x{SMALLTEX_RES} "
                             f"({sec:.2f} s on the card, {cpu_sec:.2f} s on the CPU)")
    r = checked_card_render(text, "smalltex_checked", tmp, extra=tile, expect=k1_launches)[1]
    r.pop("live_share_per_launch")
    r.pop("rays_per_launch")
    return {"seconds": sec, "k1_launches": k1_launches, "k2_launches": bvh_cuda.launches,
            "k1": r, "cpu_seconds": cpu_sec, "cpu_mean_rel": mean_rel,
            "cpu_within_1e-3": within}


def escaped_env_check(text, img, tmp, device, rows=8):
    """The escaped camera rays show the map: for the pixels of the top
    `rows` rows whose camera ray (the render's own sample: 1 spp, box
    filter) leaves the scene, the image equals the map's radiance in
    that direction, env_le, converted as the film converts it. -> (pixels
    checked, largest relative difference)."""
    import torch
    from pbrt_tpu_torch.cameras.cameras import make_camera
    from pbrt_tpu_torch.core import spectrum
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.film import film as film_mod
    from pbrt_tpu_torch.lights.lighting import env_le
    from pbrt_tpu_torch.samplers.samplers import camera_samples, make_sampler

    scene, ro = compile_text(text, "benchenv_check", tmp, device)
    film = film_mod.make_film(ro.film_name, ro.film_params,
                              film_mod.make_filter(ro.filter_name, ro.filter_params), {})
    camera = make_camera(ro.camera_name, ro.camera_params, ro.camera_to_world or Transform(),
                         film.xres, film.yres)
    sampler = make_sampler(ro.sampler_name, ro.sampler_params, {})
    ids = torch.arange(rows * film.nx, device=device)
    px, py = ids % film.nx, ids // film.nx
    cs = camera_samples(sampler, px, py, film.xres, 0)
    ray, _ = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
    escaped = ~scene.intersect(ray, coherent=True).valid
    xyz = spectrum.to_xyz(env_le(scene.lights, ray.d)).double().cpu().numpy()
    want = np.maximum(xyz @ np.asarray(spectrum.XYZ_TO_RGB).T, 0.0)
    got = img[py.cpu().numpy(), px.cpu().numpy()]
    esc = escaped.cpu().numpy()
    rel = np.abs(got[esc] - want[esc]).max(-1) / np.maximum(np.abs(want[esc]).max(-1), 1e-6)
    if esc.sum() < 100 or not (rel <= 1e-4).all():
        raise RuntimeError(f"benchenv: escaped camera rays do not show the map ({int(esc.sum())} "
                           f"escaped, worst {rel.max() if esc.any() else 0:.3g})")
    return int(esc.sum()), float(rel.max())


def phase_benchenv(tmp):
    """[16]: benchenv through the CLI on the card (timed): the bench
    geometry (K2) lit by an infinite light alone, halton, path maxdepth
    5; the escaped camera rays checked against the map; then again, its
    path loop eager, with CUDA events around every K2 launch, the
    env-map importance sampling and the escape emission -> dict."""
    from pbrt_tpu_torch.integrators import surface
    from pbrt_tpu_torch.io.image import write_image
    from pbrt_tpu_torch.lights import lighting
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    res = BENCHENV_RES
    env_path = os.path.join(tmp, "benchenv_sky.pfm")
    write_image(env_path, env_map(ENV_W, ENV_H, 16))
    text = benchenv_scene_text(res, env_path)
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain():
        img, sec = render(text, "benchenv", tmp)
    k2_launches, k1_launches = bvh_cuda.launches, intersect_cuda.launches
    lum = img.mean(-1)
    log(f"  {res}x{res}, 1 spp: {sec:.2f} s end to end (parse + compile + BVH build + render), "
        f"{res * res / sec:.0f} camera rays/s, image mean {img.mean():.5f} (luminance std "
        f"{lum.std():.5f}), K2 launches {k2_launches}, K1 launches {k1_launches}")
    if k2_launches <= 0:
        raise RuntimeError("benchenv render did not launch K2")
    if not lum.std() > 1e-3 * max(lum.mean(), 1e-9):
        raise RuntimeError("benchenv: image constant")
    n_esc, worst = escaped_env_check(text, img, tmp, "cuda")
    log(f"  escaped camera rays of the top 8 rows: {n_esc}, each pixel equals the map's "
        f"radiance in its direction (worst relative difference {worst:.3g})")

    k2 = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
    env_sample = LaunchTimer(lighting._env_direction)
    escape = LaunchTimer(surface._add_escape_emission)
    bvh_cuda.launches = 0
    with NoPlain(), Patched((bvh_cuda, "wide_sweep", k2), (lighting, "_env_direction", env_sample),
                            (surface, "_add_escape_emission", escape), eager_path_loop()):
        _, sec_ev = render(text, "benchenv_events", tmp)
    if bvh_cuda.launches != k2_launches:
        raise RuntimeError(f"benchenv: K2 launches differ between renders: "
                           f"{bvh_cuda.launches} vs {k2_launches}")
    spans = {"env_sample_ms": env_sample.total_ms(), "env_sample_calls": len(env_sample.events),
             "escape_ms": escape.total_ms(), "escape_calls": len(escape.events), **k2_spans(k2)}
    log(f"  again with events: {sec_ev:.2f} s end to end; event spans: env-map sampling "
        f"{spans['env_sample_ms']:.1f} ms over {spans['env_sample_calls']} calls, escape "
        f"emission {spans['escape_ms']:.1f} ms over {spans['escape_calls']} calls, K2 "
        f"{spans['k2_ms']:.1f} ms over {spans['k2_launches']} launches ({spans['k2_pairs']} "
        f"(tile, block) pairs, bound {spans['k2_bound_ms']:.3f} ms)")
    return {"res": res, "seconds": sec, "camera_rays_per_s": res * res / sec,
            "seconds_with_events": sec_ev, "k2_launches": k2_launches,
            "k1_launches": k1_launches, "image_mean": float(img.mean()),
            "escaped_checked": n_esc, "escaped_worst_rel": worst, "spans": spans}


def checked_card_render(text, name, tmp, extra=(), image=True, expect=None):
    """A run on the card with the plain twins refused (NoPlain) and every
    K1 launch held bit for bit against the plain twin (K1Recorder); it
    must launch K1, `expect` times where given (an earlier render's
    count) -> ((image, seconds) or seconds, K1 summary)."""
    from pbrt_tpu_torch.ops import intersect_cuda

    rec = K1Recorder(intersect_cuda.tri_t_pass_cuda, intersect_cuda.tri_t_pass_plain)
    intersect_cuda.launches = 0
    with NoPlain(), Patched((intersect_cuda, "tri_t_pass_cuda", rec)):
        out = (render if image else run_cli)(text, name, tmp, extra)
    r = rec.summary()
    if r["launches"] != intersect_cuda.launches or r["launches"] <= 0:
        raise RuntimeError(f"{name}: {r['launches']} K1 launches checked of "
                           f"{intersect_cuda.launches}")
    if expect is not None and r["launches"] != expect:
        raise RuntimeError(f"{name}: K1 launches differ between renders: "
                           f"{r['launches']} vs {expect}")
    log(f"  every one of {r['launches']} K1 launches bit-equal to the plain twin; kernel "
        f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, live share {r['live_share']:.4f}, "
        f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return out, r


def card_and_cpu(text, name, tmp, spp, k1_check=False, res=SLICE_RES):
    """Render a res^2 scene of `spp` samples a pixel (one tile of exactly
    its samples: no padding pixels) on the card (K1 launches counted)
    and on the CPU, within agree()'s limits; with k1_check, a third
    render on the card (checked_card_render) holds every K1 launch bit
    for bit against the plain twin. -> dict."""
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda
    from pbrt_tpu_torch.renderers import driver

    tile = ("--tile-samples", str(res * res * spp))
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    gpu, sec = render(text, name + "_gpu", tmp, extra=tile)
    out = {"seconds": sec, "k1_launches": intersect_cuda.launches,
           "k2_launches": bvh_cuda.launches,
           "vetoed_gpu": driver.last_stats.get("adaptive_vetoed", 0)}
    cpu, cpu_sec = render(text, name + "_cpu", tmp, extra=(*tile, "--device", "cpu"))
    out["vetoed_cpu"] = driver.last_stats.get("adaptive_vetoed", 0)
    out["cpu_seconds"] = cpu_sec
    out["cpu_mean_rel"], out["cpu_within_1e-3"] = agree(
        gpu, cpu, f"{name} ({sec:.2f} s on the card, {cpu_sec:.2f} s on the CPU)")
    if k1_check:
        out["k1"] = checked_card_render(text, name + "_checked", tmp, extra=tile,
                                        expect=out["k1_launches"])[1]
    return out


def phase_smalllights(tmp):
    """[17]: the small scene lit by an exinfinite map, a goniometric and
    a projection light (bestcandidate, path maxdepth 3, 32^2, 4 spp):
    card vs CPU, every K1 launch bit for bit. -> dict."""
    text = small_variant_text(SLICE_RES, 4, 'Sampler "bestcandidate" "integer pixelsamples" [4]',
                              depth=3, lights=slice_lights_text(slice_images(tmp)))
    out = card_and_cpu(text, "smalllights", tmp, 4, k1_check=True)
    out["k1"].pop("live_share_per_launch")
    out["k1"].pop("rays_per_launch")
    return out


def phase_samplers_cameras(tmp):
    """[18]: the small scene (path maxdepth 3, 32^2) on the card and on
    the CPU: adaptive by contrast (min 2, max 8) under the perspective
    camera, adaptive by shape id under an orthographic camera, halton
    under an environment camera. The vetoes must fire on some pixels but
    not all, on both devices alike (within 1%); K1's launches and live
    share in the adaptive second pass (its 8-sample camera rays, the
    lanes of passing pixels dead). -> dict."""
    sampler = 'Sampler "adaptive" "integer minsamples" [2] "integer maxsamples" [8]'
    cases = {
        "adaptive contrast": small_variant_text(SLICE_RES, 4, sampler, depth=3),
        "adaptive shapeid orthographic": small_variant_text(
            SLICE_RES, 4, sampler + ' "string method" "shapeid"',
            'Camera "orthographic" "float screenwindow" [-3 3 -3 3]', depth=3),
        "halton environment": small_variant_text(
            SLICE_RES, 4, 'Sampler "halton" "integer pixelsamples" [4]',
            'Camera "environment"', depth=3),
    }
    out = {}
    for name, text in cases.items():
        adaptive = name.startswith("adaptive")
        r = card_and_cpu(text, name.replace(" ", "_"), tmp, 8 if adaptive else 4,
                         k1_check=adaptive)
        if adaptive:
            n_pix = SLICE_RES * SLICE_RES
            vg, vc = r["vetoed_gpu"], r["vetoed_cpu"]
            second = [x for x, n in zip(r["k1"].pop("live_share_per_launch"),
                                        r["k1"].pop("rays_per_launch"))
                      if n == n_pix * 8]
            log(f"  vetoed pixels: card {vg}, CPU {vc} of {n_pix}; second pass: "
                f"{len(second)} K1 launches, live share {second[:6]}")
            if not (0 < vg < n_pix and 0 < vc < n_pix) or abs(vg - vc) > 0.01 * max(vc, 1):
                raise RuntimeError(f"{name}: vetoes {vg} (card) vs {vc} (CPU)")
            r["second_pass_live_share"] = second
        out[name] = r
    return out


def phase_motion(tmp):
    """[19]: (a) the small scene with its mirror sphere moving (the block
    scan at ray time, plain torch) card vs CPU at 32^2; (b) the bench
    geometry with its sphere moving (a motion scene above 32,768
    primitives: the binary-BVH walk t_pass_bvh), directlighting 256^2,
    1 spp, timed, with the walk's traversals, iterations and event spans;
    card vs CPU on a 16 x 16 crop. -> dict."""
    from pbrt_tpu_torch.accel import bvh as bvh_mod

    moving = small_variant_text(SLICE_RES, 4, depth=3, moving=True)
    a = card_and_cpu(moving, "motion_small", tmp, 4)
    if a["k1_launches"] or a["k2_launches"]:
        raise RuntimeError("motion scene reached a kernel")
    res = MOTION_BENCH_RES
    bvh_mod.walk_stats.update(traversals=0, iterations=0)
    walk = LaunchTimer(bvh_mod.t_pass_bvh)
    with Patched((bvh_mod, "t_pass_bvh", walk)):
        img, sec = render(motion_bench_text(res), "motion_bench", tmp)
    st = dict(bvh_mod.walk_stats)
    walk_ms = walk.total_ms()
    n = max(st["traversals"], 1)
    log(f"  (b) {res}x{res}: {sec:.2f} s end to end, {res * res / sec:.0f} camera rays/s; "
        f"t_pass_bvh {st['traversals']} traversals, {st['iterations'] / n:.1f} iterations and "
        f"{walk_ms / n:.2f} ms per traversal (event spans; {walk_ms / 1e3 / sec:.3f} of the "
        f"render)")
    if st["traversals"] <= 0:
        raise RuntimeError("motion bench render did not walk the binary BVH")
    cpu_sec, mean_rel, within = crop_check(motion_bench_text, res, MOTION_CROP, img,
                                           "motion_bench", tmp)
    return {"small": a, "bench": {"res": res, "seconds": sec, "camera_rays_per_s": res * res / sec,
                                  "traversals": st["traversals"],
                                  "iterations_per_traversal": st["iterations"] / n,
                                  "ms_per_traversal": walk_ms / n, "walk_ms": walk_ms,
                                  "cpu_crop_seconds": cpu_sec, "cpu_mean_rel": mean_rel,
                                  "cpu_within_1e-3": within}}


def phase_checkpoint(tmp):
    """[20]: [17]'s scene with --checkpoint and 15-pixel tiles (69 tiles;
    the CLI checkpoints every 64, so after tile 64) under --verbose, then
    again from the checkpoint file it left: the resumed image equals the
    uninterrupted one bit for bit, and the statistics counters count the
    tiles and camera samples each render did and the path loop's graphs
    each captured (2 x depth + 1: each render compiles its own scene).
    -> dict."""
    from pbrt_tpu_torch.core import probes
    from pbrt_tpu_torch.renderers import driver

    text = small_variant_text(SLICE_RES, 4, 'Sampler "bestcandidate" "integer pixelsamples" [4]',
                              depth=3, lights=slice_lights_text(slice_images(tmp)))
    ckpt = os.path.join(tmp, "film_checkpoint.npz")
    per_tile = 15
    extra = ("--tile-samples", str(per_tile * 4), "--checkpoint", ckpt, "--verbose")
    n_pix = SLICE_RES * SLICE_RES
    n_tiles = -(-n_pix // per_tile)
    probes.reset()
    full, sec = render(text, "checkpoint_full", tmp, extra=extra)
    c_full = probes.counters()
    z = np.load(ckpt)
    probes.reset()
    resumed, sec_r = render(text, "checkpoint_resumed", tmp, extra=extra)
    c_res = probes.counters()
    start = driver.last_stats["start_tile"]
    log(f"  full render {sec:.2f} s ({n_tiles} tiles; checkpoint left after tile "
        f"{int(z['tile'])}); resumed from tile {start}: {sec_r:.2f} s; counters {c_full} then "
        f"{c_res}; resumed == full bit for bit: {np.array_equal(resumed, full)}")
    if int(z["tile"]) != 64 or start != 64:
        raise RuntimeError(f"checkpoint: tile {int(z['tile'])}, resumed at {start}")
    if not np.array_equal(resumed.view(np.int32), full.view(np.int32)):
        raise RuntimeError(f"checkpoint: the resumed image differs on "
                           f"{int((resumed != full).any(-1).sum())} pixels")
    graphs = {"path/graph_captures": 2 * 3 + 1}
    want = ({"render/tiles": n_tiles, "render/camera_samples": n_pix * 4, **graphs},
            {"render/tiles": n_tiles - 64, "render/camera_samples": (n_pix - 64 * per_tile) * 4,
             **graphs})
    if (c_full, c_res) != want:
        raise RuntimeError(f"checkpoint: counters {c_full}, {c_res}, expected {want}")
    return {"seconds": sec, "resumed_seconds": sec_r, "checkpoint_tile": int(z["tile"]),
            "counters": [c_full, c_res], "bit_equal": True}


def run_slice_phases(tmp):
    """[16]-[20], the lights, samplers, cameras, motion and checkpoint
    slice -> dict."""
    out = {}
    for key, title, fn in (
            ("benchenv", f"[16] benchenv (bench geometry, infinite light alone; halton, path "
                         f"maxdepth 5) {BENCHENV_RES}x{BENCHENV_RES}, 1 spp", phase_benchenv),
            ("smalllights", "[17] small scene under an exinfinite map, a goniometric and a "
                            "projection light (bestcandidate, path maxdepth 3), card vs CPU",
             phase_smalllights),
            ("samplers", "[18] adaptive (contrast; shape id, orthographic) and halton "
                         "(environment camera), card vs CPU", phase_samplers_cameras),
            ("motion", "[19] motion blur: the block scan at ray time (small scene), the "
                       "binary-BVH walk (bench geometry)", phase_motion),
            ("checkpoint", "[20] checkpoint / resume and the statistics counters",
             phase_checkpoint)):
        log(title)
        t0 = time.perf_counter()
        out[key] = fn(tmp)
        log(f"  {title.split()[0]} took {time.perf_counter() - t0:.1f} s")
    return out


class WeightCounter:
    """Stands in for realistic.realistic_generate_rays: counts the camera
    samples and those of weight 0 (rays that miss an aperture), on the
    device, read after the render."""

    def __init__(self, fn):
        self.fn, self.zero, self.total = fn, [], 0

    def __call__(self, *args, **kw):
        ray, w = self.fn(*args, **kw)
        self.zero.append((w == 0).sum())
        self.total += w.numel()
        return ray, w

    def share(self):
        return sum(int(z) for z in self.zero) / max(self.total, 1)


def phase_benchlens(tmp):
    """[21]: benchlens through the CLI on the card, with CUDA events
    around every K2 launch: the bench geometry (K2) through Camera
    "realistic" (the biconvex lens); the share of camera samples of
    weight 0; card vs CPU on a 16 x 16 crop -> dict."""
    from pbrt_tpu_torch.cameras import realistic
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    res = BENCHLENS_RES
    text = benchlens_scene_text(res)
    weights = WeightCounter(realistic.realistic_generate_rays)
    k2 = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain(), Patched((realistic, "realistic_generate_rays", weights),
                            (bvh_cuda, "wide_sweep", k2)):
        img, sec = render(text, "benchlens", tmp)
    k2_launches, k1_launches = bvh_cuda.launches, intersect_cuda.launches
    zero_share = weights.share()
    spans = k2_spans(k2)
    log(f"  {res}x{res}, 1 spp, with events: {sec:.2f} s end to end (parse + compile + BVH "
        f"build + render), {res * res / sec:.0f} camera rays/s, image mean {img.mean():.5f}; "
        f"camera samples of weight 0 (an aperture missed): {zero_share:.4f} of "
        f"{weights.total}; K2 launches {k2_launches}, K1 launches {k1_launches}; K2 event "
        f"spans {spans['k2_ms']:.1f} ms ({spans['k2_ms'] / 1e3 / sec:.3f} of the render), "
        f"{spans['k2_pairs']} (tile, block) pairs, bound {spans['k2_bound_ms']:.3f} ms")
    if k2_launches <= 0:
        raise RuntimeError("benchlens render did not launch K2")
    if not 0.0 < zero_share < 0.5:
        raise RuntimeError(f"benchlens: {zero_share:.3f} of the camera samples have weight 0")
    cpu_sec, mean_rel, within = crop_check(benchlens_scene_text, res, BENCHLENS_CROP, img,
                                           "benchlens", tmp)
    return {"res": res, "seconds": sec, "camera_rays_per_s": res * res / sec,
            "weight0_share": zero_share, "k2_launches": k2_launches,
            "k1_launches": k1_launches, "spans": spans,
            "cpu_crop_seconds": cpu_sec, "cpu_mean_rel": mean_rel, "cpu_within_1e-3": within}


def phase_benchirr(tmp):
    """[22]: benchirr through the CLI on the card: the bench scene (K2)
    under irradiancecache (16 gather rays a hit), 512^2, with CUDA events
    around every K2 launch and every gather (extra.irradiance_gather: its
    traversal and the direct light at its hit); card vs CPU on a 16 x 16
    crop -> dict."""
    from pbrt_tpu_torch.integrators import extra
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    res = BENCHIRR_RES
    text = benchirr_scene_text(res)
    k2 = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
    gathers = LaunchTimer(extra.irradiance_gather)
    kinds = AnyHitCounter(bvh_cuda)
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain(), Patched((bvh_cuda, "wide_sweep", k2), (extra, "irradiance_gather", gathers),
                            (bvh_cuda, "wide_t_pass", kinds)):
        img, sec = render(text, "benchirr", tmp)
    k2_launches, k1_launches = bvh_cuda.launches, intersect_cuda.launches
    if k2_launches <= 0:
        raise RuntimeError("benchirr render did not launch K2")
    spans = k2_spans(k2)
    spans.update(gather_ms=gathers.total_ms(), gather_calls=len(gathers.events))
    log(f"  {res}x{res}, 1 spp, with events: {sec:.2f} s end to end, {res * res / sec:.0f} "
        f"camera rays/s, image mean {img.mean():.5f}; K2 launches {k2_launches} "
        f"({kinds.any_hit} any-hit, {kinds.closest} closest-hit), K1 launches {k1_launches}; "
        f"event spans: gathers {spans['gather_ms']:.1f} ms over {spans['gather_calls']} calls "
        f"({spans['gather_ms'] / 1e3 / sec:.3f} of the render), K2 {spans['k2_ms']:.1f} ms "
        f"({spans['k2_ms'] / 1e3 / sec:.3f}; {spans['k2_pairs']} (tile, block) pairs, bound "
        f"{spans['k2_bound_ms']:.3f} ms)")
    cpu_sec, mean_rel, within = crop_check(benchirr_scene_text, res, BENCHIRR_CROP, img,
                                           "benchirr", tmp)
    return {"res": res, "seconds": sec, "camera_rays_per_s": res * res / sec,
            "k2_launches": k2_launches, "k2_any_hit_launches": kinds.any_hit,
            "k2_closest_launches": kinds.closest, "k1_launches": k1_launches, "spans": spans,
            "gather_share": spans["gather_ms"] / 1e3 / sec, "cpu_crop_seconds": cpu_sec,
            "cpu_mean_rel": mean_rel, "cpu_within_1e-3": within}


def phase_longtail(tmp):
    """[24]: the small scene (K1) under igi, dipolesubsurface (a Marble
    sphere), diffuseprt and glossyprt (a distant light), and the chain
    surfacepoints -> createprobes -> useprobes: the point and probe files
    of both devices compared (createprobes' K1 launches on the card held
    bit for bit), then each render through card_and_cpu (every K1 launch
    bit-equal to the plain twin) -> dict."""
    out = {}
    files = {}
    for dev in ("gpu", "cpu"):
        sp, probes = (os.path.join(tmp, f"longtail_{k}_{dev}.npz") for k in ("sp", "probes"))
        files[dev] = sp, probes
        dev_args = () if dev == "gpu" else ("--device", "cpu")
        text = longtail_text('SurfaceIntegrator "path" "integer maxdepth" [5]', renderer=(
            f'Renderer "surfacepoints" "float minsampledistance" [0.25] "string filename" "{sp}"'))
        sp_sec = run_cli(text, f"longtail_sp_{dev}", tmp, dev_args)
        text = longtail_text('SurfaceIntegrator "path" "integer maxdepth" [5]', renderer=(
            f'Renderer "createprobes" "integer lmax" [2] "integer indirectsamples" [128] '
            f'"string filename" "{probes}"'))
        if dev == "gpu":
            pr_sec, r = checked_card_render(text, "longtail_probes_gpu", tmp, image=False)
            for k in ("live_share_per_launch", "rays_per_launch"):
                r.pop(k)
        else:
            pr_sec = run_cli(text, "longtail_probes_cpu", tmp, dev_args)
        out[f"files_{dev}"] = {"surfacepoints_seconds": sp_sec, "createprobes_seconds": pr_sec}
    sp_g, sp_c = (dict(np.load(files[d][0])) for d in ("gpu", "cpu"))
    if set(sp_g) != {"p", "n", "area"} or not all(np.array_equal(sp_g[k], sp_c[k]) for k in sp_g):
        raise RuntimeError("surfacepoints: the card's and the CPU's point files differ")
    pg, pc = (dict(np.load(files[d][1])) for d in ("gpu", "cpu"))
    c_rel = float(np.abs(pg["coeffs"] - pc["coeffs"]).max() / np.abs(pc["coeffs"]).max())
    log(f"  surfacepoints: {len(sp_g['p'])} points, card file == CPU file; createprobes: "
        f"{pg['coeffs'].shape} coefficients, card vs CPU max difference {c_rel:.3g} of the "
        f"largest (limit 1e-4); its {r['launches']} K1 launches on the card bit-equal")
    if c_rel > 1e-4 or not all(np.array_equal(pg[k], pc[k]) for k in ("lo", "hi", "dims", "lmax")):
        raise RuntimeError("createprobes: the card's and the CPU's probe files differ")
    out["createprobes"] = {"points": len(sp_g["p"]), "coeffs_max_rel_diff": c_rel,
                           "k1_launches": r["launches"], "k1": r}
    cases = {name: longtail_text(*case) for name, case in LONGTAIL_CASES.items()}
    cases["useprobes"] = longtail_text(f'SurfaceIntegrator "useprobes" "string filename" '
                                       f'"{files["gpu"][1]}"')
    for name, text in cases.items():
        log(f"  {name}:")
        out[name] = card_and_cpu(text, f"longtail_{name}", tmp, 4, k1_check=True)
        for k in ("live_share_per_launch", "rays_per_launch"):
            out[name]["k1"].pop(k)
    return out


def phase_autofocus(tmp):
    """[25]: the textured plane at AF_OBJ behind the biconvex lens, one
    AF zone, AF_RES^2, through card_and_cpu (AF at 16 spp from 2% long
    of the thin-lens image distance, then the render; every K1 launch of
    the checked card run bit-equal to the plain twin, the images within
    agree()'s limits); the card's and the CPU's picks must agree within
    1e-4 relative, and the card's pick must lie within 3% of the peak of
    an SML scan over 41 film distances on the card -> dict."""
    from pbrt_tpu_torch.cameras import realistic
    from pbrt_tpu_torch.renderers.driver import build_li_fn

    zones = os.path.join(tmp, "af_zones.txt")
    with open(zones, "w") as f:
        f.write("0.3 0.7 0.3 0.7\n")
    fd_img = 1.0 / (LENS_INV_F - 1.0 / AF_OBJ)
    start = 1.02 * fd_img
    text = af_plane_text(AF_RES, start, zones)
    picks = []     # card, CPU, checked card run
    real_af = realistic.autofocus

    def recording_af(scene, camera, film, li_fn, seed=0, spp=16):
        real_af(scene, camera, film, li_fn, seed=seed, spp=spp)
        picks.append(float(camera.lens.film_dist))

    with Patched((realistic, "autofocus", recording_af)):
        r = card_and_cpu(text, "af", tmp, 1, k1_check=True, res=AF_RES)
    r["k1"].pop("live_share_per_launch")
    r["k1"].pop("rays_per_launch")
    pick_gpu, pick_cpu, pick_checked = picks
    # the SML curve on the card: the zone crop at 41 film distances
    scene, ro = compile_text(text, "af_scan", tmp, "cuda")
    from pbrt_tpu_torch.cameras.cameras import make_camera
    from pbrt_tpu_torch.core.transform import Transform

    cam = make_camera(ro.camera_name, ro.camera_params, ro.camera_to_world or Transform(),
                      AF_RES, AF_RES)
    film = types.SimpleNamespace(xres=AF_RES, yres=AF_RES)
    li = build_li_fn(scene, ro, {})
    t0 = time.perf_counter()
    cands = np.linspace(0.8 * fd_img, 1.2 * fd_img, 41)
    curve = realistic.zone_sharpness(cam, film, li, cam.lens.af_zones[0], cands, 0, 16,
                                     scene.geom.tri_v0.device)
    scan_sec = time.perf_counter() - t0
    peak = float(cands[int(np.argmax(curve))])
    pick_rel = abs(pick_gpu - pick_cpu) / pick_cpu
    log(f"  film distance: start {start:.3f}, card pick {pick_gpu!r} ({r['seconds']:.2f} s with "
        f"the render, K1 launches {r['k1_launches']}; the checked run's {pick_checked!r}), CPU "
        f"pick {pick_cpu!r} ({r['cpu_seconds']:.2f} s): relative difference {pick_rel:.3g} "
        f"(limit 1e-4); SML scan peak {peak:.3f} (41 distances, {scan_sec:.2f} s; max/min "
        f"{max(curve) / min(curve):.2f}); card pick off the peak by "
        f"{abs(pick_gpu - peak) / peak:.4f} (limit 0.03)")
    if pick_rel > 1e-4 or pick_checked != pick_gpu:
        raise RuntimeError("autofocus: the card's and the CPU's picks differ")
    if abs(pick_gpu - peak) > 0.03 * peak or max(curve) < 1.5 * min(curve):
        raise RuntimeError("autofocus: the pick is not at the SML peak")
    return {"start": start, "pick_gpu": pick_gpu, "pick_cpu": pick_cpu, "pick_rel_diff": pick_rel,
            "sml_peak": peak, "scan_seconds": scan_sec, **r}


def phase_goldens_longtail(tmp):
    """[23]: the goldens irr (irradiancecache) and dprt (diffuseprt) as
    in [9]; both scenes are quadrics only, so neither kernel may launch."""
    out = phase_goldens(tmp, names=("irr", "dprt"))
    launched = {n: (g["k1_launches"], g["k2_launches"]) for n, g in out.items()
                if g["k1_launches"] or g["k2_launches"]}
    if launched:
        raise RuntimeError(f"goldens irr / dprt launched a kernel: {launched}")
    log("  irr and dprt reached no kernel (K1 and K2 launches 0): they check the "
        "integrators, not the kernels")
    return out


def run_longtail_phases(tmp):
    """[21]-[25], the realistic camera, the long-tail integrators and
    renderers -> dict."""
    out = {}
    for key, title, fn in (
            ("benchlens", f"[21] benchlens (bench geometry x {BENCHLENS_SCALE:g} through the "
                          f"biconvex lens, distant light; path maxdepth 5) {BENCHLENS_RES}x"
                          f"{BENCHLENS_RES}, 1 spp", phase_benchlens),
            ("benchirr", f"[22] benchirr (bench scene under irradiancecache, nsamples 4096: 16 "
                         f"gathers a hit) {BENCHIRR_RES}x{BENCHIRR_RES}, 1 spp", phase_benchirr),
            ("goldens", "[23] the goldens irr and dprt (quadrics only: they reach no kernel)",
             phase_goldens_longtail),
            ("longtail", "[24] small scene under igi, dipolesubsurface, diffuseprt, glossyprt; "
                         "surfacepoints -> createprobes -> useprobes; card vs CPU",
             phase_longtail),
            ("autofocus", f"[25] autofocus on the textured plane at {AF_OBJ:g} (one zone, "
                          f"{AF_RES}x{AF_RES})", phase_autofocus)):
        log(title)
        t0 = time.perf_counter()
        out[key] = fn(tmp)
        log(f"  {title.split()[0]} took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [26]-[29]: metropolis, the grid and kd-tree, aggregatetest, the tools

def with_line(text, line):
    """The scene with an option line (Renderer, Accelerator) before WorldBegin."""
    return text.replace("WorldBegin\n", line + "\nWorldBegin\n", 1)


def bench_accel_text(res, accel, n=260):
    """bench_scene_text's layout with an n x n UV sphere under
    Accelerator `accel`, directlighting maxdepth 1 (a camera walk and a
    shadow walk), 1 spp."""
    P, idx = uv_sphere(n, n, 1.0, (0.0, 0.4, 0.0))
    head = bench_scene_text(res).split('Material "matte" "rgb Kd" [.45')[0]
    head = head.replace('SurfaceIntegrator "path" "integer maxdepth" [5]',
                        'SurfaceIntegrator "directlighting" "integer maxdepth" [1]')
    return with_line(head + 'Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx)
                     + 'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX)
                     + "WorldEnd\n", f'Accelerator "{accel}"')


def scene_parts(text, name, tmp, device):
    """(CompiledScene, Film, camera) of a scene on `device`."""
    from pbrt_tpu_torch.cameras.cameras import make_camera
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.film import film as film_mod

    scene, ro = compile_text(text, name, tmp, device)
    film = film_mod.make_film(ro.film_name, ro.film_params,
                              film_mod.make_filter(ro.filter_name, ro.filter_params))
    cam = make_camera(ro.camera_name, ro.camera_params, ro.camera_to_world or Transform(),
                      film.xres, film.yres)
    return scene, film, cam


class BuildTimer:
    """Stands in for a host tree build: its seconds, call by call, and
    the last tree it built."""

    def __init__(self, fn):
        self.fn, self.seconds, self.last = fn, [], None

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        self.last = self.fn(*args, **kw)
        self.seconds.append(time.perf_counter() - t0)
        return self.last


def phase_mlt(tmp):
    """[26] metropolis: (a) path_l_psamples on MLT_W seeded primary-sample
    vectors (the small scene, maxdepth 5, bidirectional) on the card,
    every K1 launch bit-equal to the plain twin, and on the CPU, within
    agree()'s limits; (a') the same on the bench geometry on the card,
    every K2 wave held against the plain version; (b) the small scene at
    MLT_RES^2 under metropolis (16 mutations a pixel, direct pass
    separate) against the sampler renderer (8 spp) on the card: image
    means within 15%, 4 x 4 block means within 0.35 relative on average;
    (c) benchmlt: the bench geometry under metropolis (4 mutations a
    pixel, maxdepth 5) at BENCHMLT_RES^2 through the CLI, with CUDA events
    around every K2 launch -> dict."""
    import torch

    from pbrt_tpu_torch.integrators import bidir
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda
    from pbrt_tpu_torch.renderers import metropolis

    out = {}
    D = bidir.n_psample_dims(5, True)
    u = np.random.RandomState(26).rand(MLT_W, D).astype(np.float32)
    paths = {}
    for dev in ("cuda", "cpu"):
        scene, film, cam = scene_parts(small_scene_text(MLT_RES, 1), f"mlt_paths_{dev}", tmp,
                                       dev)
        ut = torch.as_tensor(u, device=dev)
        if dev == "cuda":
            rec = K1Recorder(intersect_cuda.tri_t_pass_cuda, intersect_cuda.tri_t_pass_plain)
            intersect_cuda.launches = 0
            with NoPlain(), Patched((intersect_cuda, "tri_t_pass_cuda", rec)):
                res, sec = host_s(lambda: bidir.path_l_psamples(scene, cam, film, ut, 5))
            k1 = rec.summary()
            if k1["launches"] <= 0 or k1["launches"] != intersect_cuda.launches:
                raise RuntimeError(f"[26a] {k1['launches']} K1 launches checked of "
                                   f"{intersect_cuda.launches}")
        else:
            t0 = time.perf_counter()
            res = bidir.path_l_psamples(scene, cam, film, ut, 5)
            sec = time.perf_counter() - t0
        paths[dev] = [x.cpu().numpy() for x in res] + [sec]
    (gpx, gpy, gL, g_sec), (cpx, cpy, cL, c_sec) = paths["cuda"], paths["cpu"]
    if not (np.array_equal(gpx, cpx) and np.array_equal(gpy, cpy)):
        raise RuntimeError("[26a] the chains' raster positions differ between card and CPU")
    lit = int((cL.sum(-1) > 0).sum())
    mean_rel, within = agree(gL, cL, f"(a) {MLT_W} chains' L ({lit} carry light; {g_sec:.2f} s "
                                     f"on the card, {c_sec:.2f} s on the CPU)")
    log(f"  (a) every one of {k1['launches']} K1 launches bit-equal to the plain twin; kernel "
        f"{k1['ms']:.3f} ms, plain {k1['plain_ms']:.3f} ms, live share {k1['live_share']:.4f}, "
        f"{k1['rays']} rays, bound {k1['bound_ms']:.4f} ms ({k1['bound_by']})")
    for k in ("live_share_per_launch", "rays_per_launch"):
        k1.pop(k)
    out["paths_small"] = {"seconds": g_sec, "cpu_seconds": c_sec, "lit_chains": lit,
                          "cpu_mean_rel": mean_rel, "cpu_within_1e-3": within, "k1": k1}

    scene, film, cam = scene_parts(bench_scene_text(BENCHMLT_RES), "mlt_paths_bench", tmp,
                                   "cuda")
    rec2 = SweepRecorder(bvh_cuda)
    with Patched((bvh_cuda, "wide_sweep", rec2)):
        (_, _, L), sec = host_s(lambda: bidir.path_l_psamples(
            scene, cam, film, torch.as_tensor(u, device="cuda"), 5))
    k2 = rec2.summary()
    if k2["waves"] <= 0 or not bool(torch.isfinite(L).all()):
        raise RuntimeError("[26a'] the bench paths launched no K2 or are not finite")
    log(f"  (a') bench geometry: {sec:.2f} s with every K2 wave checked; {k2['waves']} waves, "
        f"{k2['pairs']} pairs: prim identical, t bits differ on {k2['t_bits_differ']}; kernel "
        f"{k2['ms']:.3f} ms, plain {k2['plain_ms']:.3f} ms, bound {k2['bound_ms']:.3f} ms "
        f"({k2['bound_by']}); {int((L.sum(-1) > 0).sum())} chains carry light")
    out["paths_bench"] = {"seconds": sec, "k2": k2}

    tile = ("--tile-samples", str(MLT_RES * MLT_RES * 8))
    ref, ref_sec = render(small_scene_text(MLT_RES, 8), "mlt_sampler", tmp, extra=tile)
    intersect_cuda.launches = 0
    mlt, mlt_sec = render(with_line(small_scene_text(MLT_RES, 8),
                                    'Renderer "metropolis" "integer samplesperpixel" [16] '
                                    '"bool dodirectseparately" ["true"]'), "mlt_small", tmp)
    k1_mlt = intersect_cuda.launches
    st = dict(metropolis.last_stats)
    level = float(ref.mean())
    n = MLT_RES // 4
    rb = ref.reshape(4, n, 4, n, -1).mean(axis=(1, 3, 4))
    mb = mlt.reshape(4, n, 4, n, -1).mean(axis=(1, 3, 4))
    block_rel = float((np.abs(mb - rb) / np.maximum(rb, 0.1 * level)).mean())
    mean_rel = abs(float(mlt.mean()) - level) / level
    log(f"  (b) {MLT_RES}x{MLT_RES}: sampler {ref_sec:.2f} s (mean {level:.5f}), metropolis "
        f"{mlt_sec:.2f} s (mean {mlt.mean():.5f}; {st['steps']} steps, {st['bootstrap_paths']} "
        f"bootstrap paths, b {st['b']:.5g}, accepted {st['accepted']}, K1 launches {k1_mlt}): "
        f"mean rel diff {mean_rel:.4f} (limit 0.15), 4x4 block rel {block_rel:.4f} (limit 0.35)")
    if mean_rel >= 0.15 or block_rel >= 0.35 or k1_mlt <= 0:
        raise RuntimeError("[26b] metropolis disagrees with the sampler renderer")
    out["small"] = {"sampler_seconds": ref_sec, "seconds": mlt_sec, "mean_rel": mean_rel,
                    "block_rel": block_rel, "k1_launches": k1_mlt, "stats": st}

    k2t = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
    bvh_cuda.launches = 0
    text = with_line(bench_scene_text(BENCHMLT_RES),
                     'Renderer "metropolis" "integer samplesperpixel" [4]')
    with Patched((bvh_cuda, "wide_sweep", k2t)):
        img, sec = render(text, "benchmlt", tmp)
    st = dict(metropolis.last_stats)
    spans = k2_spans(k2t)
    mut = st["steps"] * st["chains"]
    lit = float((img.max(-1) > 0).mean())
    log(f"  (c) benchmlt {BENCHMLT_RES}x{BENCHMLT_RES}: {sec:.2f} s end to end with K2 events; "
        f"{st['bootstrap_paths']} bootstrap paths, {st['steps']} steps x {st['chains']} chains = "
        f"{mut} mutations ({mut / sec:.0f} mutations/s), accepted {st['accepted']} "
        f"({st['accepted'] / max(mut, 1):.3f}); b {st['b']:.5g}, splat Y {st['splat_y']:.6g} x "
        f"scale {st['splat_scale']:.5g}; K2 {spans['k2_launches']} launches, {spans['k2_ms']:.1f} "
        f"ms ({spans['k2_ms'] / 1e3 / sec:.3f} of the render), bound {spans['k2_bound_ms']:.3f} "
        f"ms; image mean {img.mean():.5f}, {lit:.3f} of pixels non-zero")
    if spans["k2_launches"] <= 0 or st["splat_y"] <= 0 or lit < 0.5:
        raise RuntimeError("[26c] benchmlt launched no K2 or carries no energy")
    out["benchmlt"] = {"res": BENCHMLT_RES, "seconds": sec, "mutations": mut,
                       "mutations_per_s": mut / sec, "image_mean": float(img.mean()),
                       "nonzero_pixels": lit, "stats": st, "spans": spans}
    return out


class WalkTimer:
    """Stands in for a walk (t_pass_grid, t_pass_kdtree): CUDA events
    around each call on the card (host seconds on the CPU), read after
    the render."""

    def __init__(self, fn):
        self.fn, self.events, self.host = fn, [], 0.0

    def __call__(self, grid, geom, ray, **kw):
        import torch

        if ray.o.is_cuda:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.fn(grid, geom, ray, **kw)
            b.record()
            self.events.append((a, b))
            return out
        t0 = time.perf_counter()
        out = self.fn(grid, geom, ray, **kw)
        self.host += time.perf_counter() - t0
        return out

    def seconds(self):
        import torch

        if self.events:
            torch.cuda.synchronize()
        return self.host + sum(a.elapsed_time(b) for a, b in self.events) / 1e3


def timed_accel_render(mod, text, name, tmp, extra=()):
    """A render under mod's accelerator (accel.grid or accel.kdtree)
    with its host build and its walks timed -> (image, dict)."""
    build = "build_grid_arrays" if mod.__name__.endswith("grid") else "build_kdtree_arrays"
    walk = "t_pass_grid" if build == "build_grid_arrays" else "t_pass_kdtree"
    bt, wt = BuildTimer(getattr(mod, build)), WalkTimer(getattr(mod, walk))
    mod.walk_stats.update(traversals=0, iterations=0)
    with Patched((mod, build, bt), (mod, walk, wt)):
        img, sec = render(text, name, tmp, extra)
    st = dict(mod.walk_stats)
    if st["traversals"] <= 0:
        raise RuntimeError(f"[27] {name}: no walk")
    return img, {"seconds": sec, "build_seconds": sum(bt.seconds), "walk_seconds": wt.seconds(),
                 "walks": st["traversals"], "iterations": st["iterations"]}


def accel_summary(r):
    n = max(r["walks"], 1)
    return (f"{r['seconds']:.2f} s: build {r['build_seconds']:.2f} s, {r['walks']} walks "
            f"{r['walk_seconds']:.2f} s ({r['iterations'] / n:.1f} iterations, "
            f"{r['walk_seconds'] / max(r['iterations'], 1) * 1e3:.2f} ms an iteration)")


def phase_accels(tmp):
    """[27] the grid and the kd-tree: the small scene under each, on the
    card against the CPU and against the card's default-accelerator
    image (agree() both), no kernel launched (the walks are plain
    torch, as in the JAX package); the bench geometry under the grid and
    benchkd (a KD_SPHERE^2 sphere) under the kd-tree on the card, with
    directlighting; every render with its host build and walks timed
    apart -> dict."""
    from pbrt_tpu_torch.accel import grid, kdtree
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    out = {}
    tile = ("--tile-samples", str(SLICE_RES * SLICE_RES * 4))
    base, base_sec = render(small_scene_text(SLICE_RES, 4), "accel_default", tmp, extra=tile)
    for name, mod in (("grid", grid), ("kdtree", kdtree)):
        text = with_line(small_scene_text(SLICE_RES, 4), f'Accelerator "{name}"')
        intersect_cuda.launches = 0
        bvh_cuda.launches = 0
        gpu, rg = timed_accel_render(mod, text, f"accel_{name}_gpu", tmp, tile)
        if intersect_cuda.launches or bvh_cuda.launches:
            raise RuntimeError(f"[27] {name}: a kernel launched")
        cpu, rc = timed_accel_render(mod, text, f"accel_{name}_cpu", tmp,
                                     (*tile, "--device", "cpu"))
        log(f"  small under {name}: card {accel_summary(rg)}; CPU {accel_summary(rc)}")
        r = {"card": rg, "cpu": rc}
        r["cpu_mean_rel"], r["cpu_within_1e-3"] = agree(gpu, cpu, f"small under {name}")
        r["default_mean_rel"], r["default_within_1e-3"] = agree(
            gpu, base, f"small under {name} vs the default accelerator ({base_sec:.2f} s)")
        out[f"small_{name}"] = r
    for name, mod, res, text in (
            ("bench_grid", grid, GRID_BENCH_RES, bench_accel_text(GRID_BENCH_RES, "grid")),
            ("benchkd", kdtree, KD_RES, bench_accel_text(KD_RES, "kdtree", KD_SPHERE))):
        img, r = timed_accel_render(mod, text, name, tmp)
        log(f"  {name} {res}x{res}: {accel_summary(r)}; image mean {img.mean():.5f}")
        out[name] = {"res": res, "image_mean": float(img.mean()), **r}
    return out


def largest_prim_leaf(tree, geom):
    """The leaf of a binary tree holding the primitive of the largest box."""
    from pbrt_tpu_torch.accel.bvh import prim_bounds

    lo, hi = prim_bounds(geom)
    big = int(np.argmax(np.prod(np.maximum(hi - lo, 1e-3), -1)))
    meta = tree.node_meta.cpu().numpy()
    pos = int(np.nonzero(tree.prim_ids.cpu().numpy() == big)[0][0])
    return int(np.nonzero((meta[:, 1] > 0) & (meta[:, 0] <= pos)
                          & (pos < meta[:, 0] + meta[:, 1]))[0][0])


def phase_aggregatetest(tmp):
    """[28] aggregatetest on [19b]'s motion bench geometry (a binary tree
    is built): niters 100000 through the CLI on the card, 0 mismatches;
    then run_aggregate_test with the box of the leaf holding the largest
    primitive shrunk to its centre, 1,024 rays on the card and on the
    CPU: the same non-zero count -> dict."""
    import torch

    from pbrt_tpu_torch.renderers import aggregatetest

    text = motion_bench_text(64)
    sec = run_cli(with_line(text, 'Renderer "aggregatetest" "integer niters" [100000]'),
                  "aggtest", tmp)
    st = dict(aggregatetest.last_stats)
    log(f"  {st['rays']} rays in {st['batches']} batches, {sec:.2f} s end to end: "
        f"{st['mismatches']} mismatches")
    if st["rays"] < 100000 or st["mismatches"] != 0:
        raise RuntimeError("[28] aggregatetest found mismatches or traced no rays")
    counts = {}
    for dev in ("cuda", "cpu"):
        scene, ro = compile_text(text, f"aggtest_{dev}", tmp, dev)
        tree = scene.accel.bvh
        leaf = largest_prim_leaf(tree, scene.geom)
        lo, hi = tree.node_lo.clone(), tree.node_hi.clone()
        lo[leaf] = hi[leaf] = 0.5 * (tree.node_lo[leaf] + tree.node_hi[leaf])
        scene.accel = scene.accel._replace(bvh=tree._replace(node_lo=lo, node_hi=hi))
        t0 = time.perf_counter()
        counts[dev] = (aggregatetest.run_aggregate_test(scene, ro, n_iters=1024, batch=1024),
                       time.perf_counter() - t0, leaf)
        if dev == "cuda":
            torch.cuda.synchronize()
    log(f"  leaf {counts['cuda'][2]} shrunk: {counts['cuda'][0]} mismatches on the card "
        f"({counts['cuda'][1]:.2f} s), {counts['cpu'][0]} on the CPU ({counts['cpu'][1]:.2f} s)")
    if counts["cuda"][0] != counts["cpu"][0] or counts["cuda"][0] <= 0:
        raise RuntimeError("[28] the shrunk leaf's mismatches differ or are none")
    return {"seconds": sec, "stats": st, "shrunk_leaf_mismatches": counts["cuda"][0],
            "shrunk_card_seconds": counts["cuda"][1], "shrunk_cpu_seconds": counts["cpu"][1]}


def phase_tools(tmp):
    """[29] the tools: bsdftest 16384 on the card exits 0 and its 42
    estimates agree with the CPU's within 1e-5; exrdiff on EXRs the card
    wrote (the same image: 0; another sample count: 1, as the JAX tool
    exits); obj2pbrt's output (a UV sphere and a floor) renders on the
    card through K1 -> dict."""
    import torch

    from pbrt_tpu_torch.ops import intersect_cuda
    from pbrt_tpu_torch.tools import __main__ as tools
    from pbrt_tpu_torch.tools import bsdftest

    t0 = time.perf_counter()
    if tools.main(["bsdftest", "16384"]) != 0:
        raise RuntimeError("[29] bsdftest failed on the card")
    bsdf_sec = time.perf_counter() - t0
    gpu = bsdftest.bsdf_estimates(16384, torch.device("cuda"))
    cpu = bsdftest.bsdf_estimates(16384, torch.device("cpu"))
    diff = max(abs(a - b) for rg, rc in zip(gpu, cpu) for a, b in zip(rg[3:], rc[3:])
               if a is not None)
    log(f"  bsdftest 16384 on the card: exit 0 in {bsdf_sec:.2f} s; card vs CPU estimates max "
        f"difference {diff:.3g} (limit 1e-5)")
    if diff > 1e-5:
        raise RuntimeError("[29] bsdftest's card and CPU estimates differ")
    exrs = [os.path.join(tmp, f"tools_{k}.exr") for k in ("a", "b")]
    for path, spp in zip(exrs, (4, 8)):
        run_cli(small_scene_text(SLICE_RES, spp), os.path.basename(path)[:-4], tmp,
                ("--outfile", path))
    rc_same = tools.main(["exrdiff", exrs[0], exrs[0]])
    rc_diff = tools.main(["exrdiff", exrs[0], exrs[1]])
    log(f"  exrdiff: same image {rc_same}, 4 vs 8 spp {rc_diff} (expected 0 and 1)")
    if (rc_same, rc_diff) != (0, 1):
        raise RuntimeError("[29] exrdiff's exit codes")
    P, idx = uv_sphere(30, 30, 0.5, (0.0, 0.5, 0.0))
    obj = os.path.join(tmp, "tools_mesh.obj")
    with open(obj, "w") as f:
        f.write("".join(f"v {x:.7g} {y:.7g} {z:.7g}\n" for x, y, z in P))
        f.write("".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in idx.reshape(-1, 3)))
        f.write("".join(f"v {x:.7g} {y:.7g} {z:.7g}\n" for x, y, z in FLOOR))
        f.write(f"f {len(P) + 1} {len(P) + 3} {len(P) + 2}\nf {len(P) + 1} {len(P) + 4} "
                f"{len(P) + 3}\n")
    conv = os.path.join(tmp, "tools_mesh.pbrt")
    if tools.main(["obj2pbrt", obj, conv]) != 0:
        raise RuntimeError("[29] obj2pbrt failed")
    text = (f'Film "image" "integer xresolution" [{SLICE_RES}] "integer yresolution" '
            f'[{SLICE_RES}]\nSampler "lowdiscrepancy" "integer pixelsamples" [4]\n'
            'LookAt 0 1.5 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "path" "integer maxdepth" [3]\nWorldBegin\n'
            'LightSource "point" "point from" [2 4 -3] "rgb I" [20 20 20]\n'
            f'Material "matte" "rgb Kd" [.5 .4 .3]\nInclude "{conv}"\nWorldEnd\n')
    intersect_cuda.launches = 0
    img, sec = render(text, "tools_obj", tmp)
    k1 = intersect_cuda.launches
    log(f"  obj2pbrt: {len(idx) // 3 + 2} triangles converted, rendered on the card in "
        f"{sec:.2f} s (K1 launches {k1}, image mean {img.mean():.5f})")
    if k1 <= 0:
        raise RuntimeError("[29] the converted mesh's render launched no K1")
    return {"bsdftest_seconds": bsdf_sec, "bsdf_max_diff": diff, "exrdiff": [rc_same, rc_diff],
            "obj_seconds": sec, "k1_launches": k1}


def run_mlt_phases(tmp):
    """[26]-[29], metropolis, the grid and kd-tree, aggregatetest and the
    tools -> dict."""
    out = {}
    for key, title, fn in (
            ("mlt", "[26] metropolis: bidirectional paths (K1 small scene, K2 bench geometry), "
                    "MLT vs sampler, benchmlt", phase_mlt),
            ("accels", f"[27] grid and kd-tree: the small scene card vs CPU vs default; the bench "
                       f"geometry under the grid, benchkd ({2 * KD_SPHERE * KD_SPHERE + 2} "
                       f"triangles) under the kd-tree", phase_accels),
            ("aggtest", "[28] aggregatetest on the motion bench geometry (binary tree)",
             phase_aggregatetest),
            ("tools", "[29] tools: bsdftest, exrdiff, obj2pbrt", phase_tools)):
        log(title)
        t0 = time.perf_counter()
        out[key] = fn(tmp)
        log(f"  {title.split()[0]} took {time.perf_counter() - t0:.1f} s")
    return out


def compile_text(scene_text, out_name, tmp, device):
    """Parse a scene and compile it on `device` without rendering ->
    (CompiledScene, RenderOptions)."""
    from pbrt_tpu_torch.scene import api, parser
    from pbrt_tpu_torch.scene.compile import compile_scene

    path = os.path.join(tmp, out_name + ".pbrt")
    with open(path, "w") as f:
        f.write(scene_text)

    class Capture:
        ro = None

        def __getattr__(self, name):
            return getattr(api, name)

        def pbrt_world_end(self):
            Capture.ro = api.get_state().render_options
            api.pbrt_world_end(render=False)

    api.pbrt_init({"quiet": True, "device": str(device)})
    try:
        parser.parse_file(path, api=Capture())
    finally:
        api._state.__init__()
    return compile_scene(Capture.ro, device), Capture.ro


def host_s(fn):
    """Host seconds of fn() up to a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def knn_work(pm, q, k, max_d2, found=None):
    """The data-dependent work of a kNN lookup over these queries: (valid
    candidates, distinct candidate photons, distinct selected photons,
    photons found). Candidates: the photons of each query's in-grid
    neighbour cells, at most `cap` a cell; selected: the top-k set."""
    import torch
    from pbrt_tpu_torch.photon import map as pmap

    cap = pmap.default_cap(k)
    cid, inb = pmap._neighbour_cells(pm, q)
    cnt = torch.clamp(pm.cell_start[cid + 1] - pm.cell_start[cid], max=cap)
    valid = int(torch.where(inb, cnt, 0).sum())
    cells = torch.unique(cid[inb])
    distinct = int(torch.clamp(pm.cell_start[cells + 1] - pm.cell_start[cells], max=cap).sum())
    seen = torch.zeros(pm.count, dtype=torch.bool, device=q.device)
    n_found = 0
    live = pmap.live_queries(pm, q)
    block = pmap.query_block(k, cap, q.device)
    for s in range(0, live.shape[0], block):
        tk = pmap.topk_phase(pm, q[live[s:s + block]], k, max_d2, cap)
        seen[tk.gi[tk.valid]] = True
        n_found += int(tk.n_found.sum())
    return valid, distinct, int(seen.sum()), n_found


def knn_bound(work, Q, n_out_spectra=1):
    """(flops, bytes) of a kNN density estimate: 8 flops per candidate
    distance, 2 S per found photon's weighted spectrum; candidate
    positions (12 B) and selected photons' spectrum, direction and
    occupancy (4 S + 16 B) read once, the queries (12 B) and the result
    (4 S + 16 B per query and output spectrum) once."""
    valid, distinct, selected, found = work
    flops = valid * 8 + found * 2 * S_BINS * n_out_spectra
    nbytes = distinct * 12 + selected * (4 * S_BINS + 16) + Q * (12 + (4 * S_BINS + 16)
                                                                 * n_out_spectra)
    return flops, nbytes


def phase_photon_legs(tmp, device):
    """[12]: bench.py's photon legs on a scattering cube (sigma_a .05,
    sigma_s .9) and a point light: shooting (B = 32,768, depth 5,
    Woodcock), kNN at nused 500 on a 1M-photon map for 65,536 queries,
    the build of that map, and the photonvolume march (128^2 rays x 64
    steps) on the shot volume photons; each with its bound. -> dict."""
    import torch
    from pbrt_tpu_torch.core.geometry import Ray
    from pbrt_tpu_torch.integrators import photonvolume as pv
    from pbrt_tpu_torch.photon import map as pmap
    from pbrt_tpu_torch.photon import shooter

    S = S_BINS
    scene, _ = compile_text(PHOTON_LEGS_SCENE, "photon_legs", tmp, device)
    B, D, iters = SHOOT_B, 5, 4
    batch = shooter.shoot_batch_fn(scene, D, True)
    lane = torch.arange(B, device=device)

    def shoot(i):
        r = batch(lane, torch.full((B,), i * B, dtype=torch.int64, device=device), 0)
        code = torch.where(r["alpha"].sum(-1) > 0, r["cls"], 0).reshape(-1)
        return r, code, torch.bincount(code, minlength=5).tolist()   # the shooter's one fetch

    shoot(iters)   # warm-up, at other counters
    recs, shoot_s = host_s(lambda: [shoot(i) for i in range(iters)])
    shoot_s /= iters
    stored = sum(sum(c[1:]) for _, _, c in recs) / iters
    # bound: the records written once; 18 S flops per path segment (4
    # Woodcock trials x (sigma_t + its Y weight) 3 S, albedo 4 S, the
    # phase weight and the record 2 S)
    rec_bytes = sum(v.numel() * v.element_size() for v in recs[0][0].values())
    s_bound = bound(B * 2 * D * 18 * S, rec_bytes)
    log(f"  shooting: {shoot_s * 1e3:.1f} ms per batch of {B} paths (depth {D}, host clock, "
        f"one fetch each), {B / shoot_s:.0f} paths/s, {stored / shoot_s:.0f} stored photons/s "
        f"({stored:.0f} a batch); bound {s_bound[0]:.4f} ms ({s_bound[1]}: {rec_bytes} bytes of "
        f"records), {s_bound[0] / (shoot_s * 1e3):.2%} of bound")

    rng = np.random.RandomState(0)
    ppos = rng.normal(0.0, 0.6, (KNN_P, 3)).astype(np.float32)
    palpha = (rng.rand(KNN_P, S) * 1e-6).astype(np.float32)
    pwi = rng.normal(size=(KNN_P, 3)).astype(np.float32)
    pwi /= np.linalg.norm(pwi, axis=-1, keepdims=True)
    pmap.build_photon_map(ppos[:1000], palpha[:1000], pwi[:1000], 0.05, 500, device)  # warm-up
    pm, build_s = host_s(lambda: pmap.build_photon_map(ppos, palpha, pwi, 0.05, target_k=500,
                                                       device=device))
    b_bound = bound(0, KNN_P * 2 * (12 + 4 * S + 12) + KNN_P * 4 + (len(pm.cell_start)) * 8)
    log(f"  {KNN_P}-photon map build (host structure + upload + sort): {build_s:.3f} s; grid "
        f"{pm.dims}, bound {b_bound[0]:.4f} ms ({b_bound[1]})")

    q = torch.as_tensor(rng.normal(0.0, 0.5, (KNN_Q, 3)).astype(np.float32), device=device)

    def ones(wx, wy, wz, d2, valid, r2):
        return torch.ones_like(d2)

    knn_ms = cuda_ms(lambda: pmap.knn_weighted_flux(pm, q, KNN_K, 0.16, ones), iters=3)
    cap = pmap.default_cap(KNN_K)
    live = pmap.live_queries(pm, q)
    blk = pmap.query_block(KNN_K, cap, device)
    keys = []
    for s in range(0, live.shape[0], blk):
        qb = q[live[s:s + blk]]
        idx, ok = pmap._gather_candidates(pm, qb, cap)
        d2 = torch.where(ok, pmap._sq_dist(pm.pos[idx], qb), float("inf"))
        keys.append((d2.view(torch.int32).to(torch.int64) << 32)
                    | torch.arange(d2.shape[1], device=device))
    topk_ms = cuda_ms(lambda: [torch.topk(k_, KNN_K, dim=1, largest=False, sorted=True)
                               for k_ in keys], iters=3)
    del keys
    work = knn_work(pm, q, KNN_K, 0.16)
    k_bound = bound(*knn_bound(work, KNN_Q))
    log(f"  kNN, nused {KNN_K}, {KNN_P} photons, Q = {KNN_Q}: {knn_ms:.2f} ms "
        f"({KNN_Q / knn_ms * 1e3:.0f} lookups/s; CUDA events), of which torch.topk over the "
        f"[{blk}, {27 * cap}] key blocks {topk_ms:.2f} ms; {work[0]} candidates "
        f"({work[1]} distinct), {work[3]} found ({work[2]} distinct); bound "
        f"{k_bound[0]:.4f} ms ({k_bound[1]}), {k_bound[0] / knn_ms:.2%} of bound")
    del pm

    vm = torch.cat([c == shooter.C_VOLUME for _, c, _ in recs])
    cat = {k: torch.cat([r[k].reshape(-1, r[k].shape[-1]) for r, _, _ in recs])[vm]
           for k in ("pos", "alpha", "wi")}
    vol_map = pmap.build_photon_map(cat["pos"], cat["alpha"] / (iters * B), cat["wi"], 0.35,
                                    target_k=100, device=device)
    ctx = shooter.PhotonCtx(None, None, vol_map, None, None, 1, 1, iters * B, n_used=50,
                            max_dist2=0.01, vol_n_used=100, vol_max_dist2=0.35 * 0.35,
                            final_gather=False, gather_samples=1, cos_gather_angle=0.98,
                            max_specular_depth=5, max_photon_depth=5)
    R = MARCH_SIDE * MARCH_SIDE
    xs = np.linspace(-0.4, 0.4, MARCH_SIDE, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    d = np.stack([gx.ravel(), gy.ravel(), np.ones(R, np.float32)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.0, 0.5, -4.0]], np.float32), (R, 1))
    zeros = torch.zeros(R, device=device)
    inf = torch.full((R,), float("inf"), device=device)
    ray = Ray(torch.as_tensor(o, device=device), torch.as_tensor(d, device=device), zeros, inf,
              zeros)
    pix = torch.arange(R, device=device)

    def march():
        return pv.li_photonvolume(scene, ctx, ray, inf, pix, torch.zeros_like(pix), MARCH_STEPS,
                                  seed=0)

    # the march's kNN work, counted in one untimed run
    works = []
    real = pmap.knn_weighted_flux

    def counting(pm_, q_, k, max_d2, *a, mask=None, **kw):
        live_q = q_[mask] if mask is not None else q_
        works.append(knn_work(pm_, live_q, k, max_d2) + (live_q.shape[0],))
        return real(pm_, q_, k, max_d2, *a, mask=mask, **kw)

    with Patched((pmap, "knn_weighted_flux", counting)):
        vr = march()
    if not (bool(torch.isfinite(vr.L).all()) and float(vr.L.sum()) > 0):
        raise RuntimeError("[12] march: radiance not finite or black")
    march_ms = cuda_ms(march, iters=2)
    m_flops = m_bytes = 0
    for w in works:
        f_, b_ = knn_bound(w[:4], w[4])
        m_flops, m_bytes = m_flops + f_, m_bytes + b_
    # per sample besides the kNN: the step's sigma and Tr (3 S), the shadow
    # transmittance's max(4, steps / 4) sub-steps (3 S each), source and
    # update (6 S); the result L and Tr written once
    sub = max(4, MARCH_STEPS // 4)
    m_flops += R * MARCH_STEPS * (3 + 3 * sub + 6) * S
    m_bytes += R * (2 * 4 * S + 24)
    m_bound = bound(m_flops, m_bytes)
    log(f"  march, {MARCH_SIDE}^2 rays x {MARCH_STEPS} steps, volume map {vol_map.count} "
        f"photons: {march_ms:.2f} ms ({R * MARCH_STEPS / march_ms * 1e3:.0f} samples/s; CUDA "
        f"events); bound {m_bound[0]:.4f} ms ({m_bound[1]}), {m_bound[0] / march_ms:.2%} of "
        f"bound")
    return {"shoot_ms_per_batch": shoot_s * 1e3, "paths_per_s": B / shoot_s,
            "stored_photons_per_s": stored / shoot_s, "shoot_bound_ms": s_bound[0],
            "shoot_bound_by": s_bound[1], "map_build_1m_s": build_s,
            "map_build_bound_ms": b_bound[0], "knn_ms": knn_ms, "knn_topk_ms": topk_ms,
            "knn_lookups_per_s": KNN_Q / knn_ms * 1e3, "knn_work": list(work),
            "knn_bound_ms": k_bound[0], "knn_bound_by": k_bound[1], "march_ms": march_ms,
            "march_samples_per_s": R * MARCH_STEPS / march_ms * 1e3,
            "march_bound_ms": m_bound[0], "march_bound_by": m_bound[1],
            "vol_map_photons": vol_map.count}


def phase_benchphoton(tmp, device):
    """[13]: benchphoton at full size: every K2 launch of one shooting
    batch held bit for bit against the plain twin; then the render
    through the CLI on the card with CUDA events around every kNN lookup,
    the final gather, the march and every K2 launch. -> dict."""
    import torch
    from pbrt_tpu_torch.integrators import photonmap as pm_int
    from pbrt_tpu_torch.integrators import photonvolume as pv_int
    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda
    from pbrt_tpu_torch.photon import map as pmap
    from pbrt_tpu_torch.photon import shooter

    res = BENCHPHOTON_RES
    text = benchphoton_scene_text(res)
    scene, _ = compile_text(text, "benchphoton_compile", tmp, device)
    rec = SweepRecorder(bvh_cuda)
    with Patched((bvh_cuda, "wide_sweep", rec)):
        shooter.shoot_batch_fn(scene, 5, True)(torch.arange(SHOOT_B, device=device),
                                               torch.zeros(SHOOT_B, dtype=torch.int64,
                                                           device=device), 0)
    m = rec.summary()
    if m["t_bits_differ"]:
        raise RuntimeError(f"benchphoton: K2 t bits differ from the plain twin on "
                           f"{m['t_bits_differ']} rays in the first shooting batch")
    log(f"  first shooting batch ({SHOOT_B} paths): {m['waves']} K2 waves, {m['pairs']} pairs, "
        f"every one prim identical and t bit-equal to the plain twin; kernel {m['ms']:.3f} ms, "
        f"plain {m['plain_ms']:.3f} ms, bound {m['bound_ms']:.3f} ms ({m['bound_by']})")
    del scene
    torch.cuda.empty_cache()

    ctxs = []
    real_build = shooter.build_photon_maps

    def build(*a, **kw):
        ctxs.append(real_build(*a, **kw))
        return ctxs[-1]

    spans = {"knn_weighted_flux": LaunchTimer(pmap.knn_weighted_flux),
             "knn_dirs": LaunchTimer(pmap.knn_dirs),
             "radiance_lookup": LaunchTimer(pmap.radiance_lookup),
             "final_gather": LaunchTimer(pm_int._final_gather),
             "march": LaunchTimer(pv_int.li_photonvolume),
             "k2": LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)}
    kinds = AnyHitCounter(bvh_cuda)
    intersect_cuda.launches = 0
    bvh_cuda.launches = 0
    with NoPlain(), Patched((shooter, "build_photon_maps", build),
                            (pmap, "knn_weighted_flux", spans["knn_weighted_flux"]),
                            (pmap, "knn_dirs", spans["knn_dirs"]),
                            (pmap, "radiance_lookup", spans["radiance_lookup"]),
                            (pm_int, "_final_gather", spans["final_gather"]),
                            (pv_int, "li_photonvolume", spans["march"]),
                            (bvh_cuda, "wide_sweep", spans["k2"]),
                            (bvh_cuda, "wide_t_pass", kinds)):
        img, sec = render(text, "benchphoton", tmp)
    k2_launches, k1_launches = bvh_cuda.launches, intersect_cuda.launches
    st = ctxs[0].stats
    short = {n: c for n, c in st["counts"].items() if c[0] < c[1]}
    log(f"  {res}x{res}, 1 spp: {sec:.2f} s end to end (parse + compile + BVH build + shooting "
        f"+ map builds + render, CUDA events in place), image mean {img.mean():.5f}; K2 launches "
        f"{k2_launches} ({kinds.any_hit} any-hit, {kinds.closest} closest-hit), K1 launches "
        f"{k1_launches}")
    log(f"  shooting: {st['shoot_seconds']:.2f} s, {st['batches']} batches of {st['batch']} "
        f"({st['shots']} paths), {st['syncs']} shooter fetches; map builds and radiance "
        f"precompute {st['build_seconds']:.2f} s; stored / quota: "
        + ", ".join(f"{n} {c[0]} / {c[1]}" for n, c in st["counts"].items())
        + f"; radiance photons {st['radiance']}; aborted {st['aborted']}")
    if st["aborted"] or short:
        raise RuntimeError(f"benchphoton: quotas not filled: {short or 'hopeless abort'}")
    if k2_launches <= 0:
        raise RuntimeError("benchphoton render did not launch K2")
    work = spans["k2"].work_rows()
    per_launch = [k2_launch_bound(*w) for w in work]
    out = {f"{n}_ms": t.total_ms() for n, t in spans.items()}
    out.update({f"{n}_calls": len(t.events) for n, t in spans.items()})
    out.update({"k2_pairs": sum(w[0] for w in work),
                "k2_bound_ms": sum(max(f, b) for f, b in per_launch)})
    log("  event spans (nested: the march and the final gather hold kNN and K2 spans; kNN "
        "spans include the radiance precompute's): "
        + ", ".join(f"{n} {out[n + '_ms']:.1f} ms over {out[n + '_calls']} calls" for n in spans)
        + f"; K2 pairs {out['k2_pairs']}, bound {out['k2_bound_ms']:.3f} ms")
    return {"res": res, "seconds": sec, "k2_launches": k2_launches,
            "k2_any_hit_launches": kinds.any_hit, "k2_closest_launches": kinds.closest,
            "k1_launches": k1_launches, "first_batch_k2": m, "stats": st, "spans": out}


# ---------------------------------------------------------------------------
# [30]: gradients (pbrt_tpu_torch/diff.py) on the card. The estimators are
# tests/test_grad.py's four, in the port; tests/test_torch_grad.py holds
# them against the JAX package's jax.grad on the CPU.

# tests/test_grad.py's frozen shoot, its photon-splat query points and, per
# estimator, (scene, central-difference step h, rtol)
GRAD_FREEZE = dict(n_paths=2048, vol_quota=1, seed=3, max_depth=5, n_used=20, max_dist=0.5,
                   vol_n_used=20, vol_max_dist=0.7)
GRAD_Q_PTS = np.array([[0.0, 0.6, 0.0], [0.2, 0.2, 0.2], [-0.3, 1.0, 0.1], [0.0, 1.4, -0.2]],
                      np.float32)
GRAD_FD = {"march": ("plain", 1e-2, 2e-2), "path": ("plain", 1e-2, 2e-2),
           "splat": ("photon", 1e-2, 1e-3), "photonvolume": ("photon", 5e-3, 5e-2)}
GRAD_RTOL, GRAD_LOSS_RTOL = 1e-3, 1e-4   # card vs CPU (the port vs JAX limits)
GRAD_SMALL_RES, GRAD_SMALL_SPP = 64, 4   # [30b]
GRAD_TILE_RAYS = 1 << 16                 # [30b], [30c]: rays per autograd tile
DIST_RES = 64                            # [31]
FALLBACK_RES = 256                       # [32]: one 256^2 view of camera rays
FALLBACK_AGREE = 0.999                   # [32]: least share of rays with the native tree's prim


def grad_scene(api, ParamSet, compile_fn, with_floor=True, sigma_s=0.6):
    """tests/test_grad.py's scene (a point light above a scattering
    homogeneous cube over a matte disk) through a package's api and
    compiler: this package's, or the JAX package's in the CPU test."""
    api._state.__init__()
    api.pbrt_init({"quiet": True})
    api.pbrt_look_at([0, 0.5, -4], [0, 0, 0], [0, 1, 0])
    cam_p = ParamSet()
    cam_p.add("float", "fov", [45.0])
    api.pbrt_camera("perspective", cam_p)
    api.pbrt_world_begin()
    lp = ParamSet()
    lp.add("point", "from", [0.0, 2.5, 0.0])
    lp.add("rgb", "I", [30.0, 30.0, 30.0])
    api.pbrt_light_source("point", lp)
    if with_floor:
        api.pbrt_attribute_begin()
        api.pbrt_translate(0.0, -1.4, 0.0)
        api.pbrt_rotate(-90.0, 1.0, 0.0, 0.0)
        m2 = ParamSet()
        m2.add("rgb", "Kd", [0.6, 0.45, 0.3])
        api.pbrt_material("matte", m2)
        d = ParamSet()
        d.add("float", "radius", [6.0])
        api.pbrt_shape("disk", d)
        api.pbrt_attribute_end()
    vp = ParamSet()
    vp.add("point", "p0", [-1.5, -1.2, -1.5])
    vp.add("point", "p1", [1.5, 1.8, 1.5])
    vp.add("rgb", "sigma_a", [0.08, 0.08, 0.08])
    vp.add("rgb", "sigma_s", [sigma_s] * 3)
    api.pbrt_volume("homogeneous", vp)
    try:
        return compile_fn(api.get_state().render_options)
    finally:
        api._state.__init__()


def grad_port_scene(device, **kw):
    from pbrt_tpu_torch.scene import api
    from pbrt_tpu_torch.scene.compile import compile_scene
    from pbrt_tpu_torch.scene.paramset import ParamSet

    return grad_scene(api, ParamSet, lambda ro: compile_scene(ro, device), **kw)


def grad_ray_arrays(n_side=8, z=-4.0, y=0.5, miss_half=False):
    """tests/test_grad.py's rays as NumPy (o, d); miss_half turns every
    other ray away from the scene (up and back, past the light and the
    cube)."""
    xs = np.linspace(-0.45, 0.45, n_side, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    n = n_side * n_side
    d = np.stack([gx.ravel(), gy.ravel(), np.ones(n, np.float32)], -1)
    if miss_half:
        d[1::2] = np.array([0.1, 1.0, -1.0], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.array([[0.0, y, z]], np.float32), (n, 1))
    return o, d


def grad_port_rays(o, d, device):
    """(Ray, pixel, sample index) of NumPy origins and directions."""
    import torch
    from pbrt_tpu_torch.core.geometry import Ray

    n = len(o)
    return (Ray(torch.as_tensor(o, device=device), torch.as_tensor(d, device=device),
                torch.zeros(n, device=device), torch.full((n,), float("inf"), device=device),
                torch.zeros(n, device=device)),
            torch.arange(n, dtype=torch.int64, device=device),
            torch.zeros(n, dtype=torch.int64, device=device))


def grad_port_losses(scene, frozen):
    """test_grad.py's four estimators in the port, on the scene's device:
    name -> loss(s) for a 0-d scale tensor s."""
    import torch
    from pbrt_tpu_torch import diff
    from pbrt_tpu_torch.integrators import photonvolume as pv
    from pbrt_tpu_torch.integrators import surface, volume

    dev = scene.geom.tri_v0.device
    base_sa, base_ss = scene.volume.sigma_a, scene.volume.sigma_s
    M, S = len(scene.materials), S_BINS

    def inf(n):
        return torch.full((n,), float("inf"), device=dev)

    def march(s):
        ray, pixel, sidx = grad_port_rays(*grad_ray_arrays(6), dev)
        sc = diff.apply_params(scene, diff.DiffParams(sigma_a=base_sa * s))
        vr = volume.li_single(sc, ray, inf(len(pixel)), pixel, sidx, n_steps=8, seed=0)
        return torch.mean(vr.L) + torch.mean(vr.Tr)

    def path(s):
        ray, pixel, sidx = grad_port_rays(*grad_ray_arrays(6, y=-0.2), dev)
        sc = diff.apply_params(scene, diff.DiffParams(kd_scale=torch.ones(M, S, device=dev) * s))
        return torch.mean(surface.li_path(sc, ray, pixel, sidx, max_depth=2, seed=0))

    def splat(s):
        sc = diff.apply_params(scene, diff.DiffParams(
            light_scale=torch.ones(scene.n_lights, device=dev) * s))
        ctx = diff.diff_photon_ctx(sc, frozen)
        w = torch.tensor([[0.0, 0.0, 1.0]], device=dev).repeat(4, 1)
        flux, _ = pv.lphoton_volume(ctx.volume, torch.as_tensor(GRAD_Q_PTS, device=dev), w,
                                    torch.zeros(4, device=dev), ctx.vol_n_used,
                                    ctx.vol_max_dist2)
        return torch.mean(flux)

    def photonvolume(s):
        ray, pixel, sidx = grad_port_rays(*grad_ray_arrays(4), dev)
        sc = diff.apply_params(scene, diff.DiffParams(sigma_s=base_ss * s))
        ctx = diff.diff_photon_ctx(sc, frozen)
        vr = pv.li_photonvolume(sc, ctx, ray, inf(len(pixel)), pixel, sidx, n_steps=8, seed=0)
        return torch.mean(vr.L) + 0.1 * torch.mean(vr.Tr)

    return {"march": march, "path": path, "splat": splat, "photonvolume": photonvolume}


def port_grad(loss_fn, device, s0=1.0):
    """(d loss / d s, loss) at s0 by autograd."""
    import torch

    s = torch.tensor(s0, device=device, requires_grad=True)
    loss = loss_fn(s)
    (g,) = torch.autograd.grad(loss, s)
    return float(g), float(loss.detach())


def port_fd(loss_fn, device, h):
    """Central difference of loss at s = 1 in float32 steps."""
    import torch

    with torch.no_grad():
        lp, lm = (float(loss_fn(torch.tensor(float(np.float32(1.0) + np.float32(sh)),
                                             device=device)))
                  for sh in (h, -h))
    return (lp - lm) / (2.0 * h)


def phase_grad_estimators(device):
    """[30a]: the four estimators on the card, against the port's CPU
    gradient of the same estimator (over the CPU's frozen shoot) and
    central differences on the card; the card's own frozen shoot must
    hold the CPU's deposits. -> dict."""
    import torch
    from pbrt_tpu_torch import diff

    cpu = torch.device("cpu")
    scenes = {dev: {"plain": grad_port_scene(dev), "photon": grad_port_scene(dev, sigma_s=0.9)}
              for dev in (device, cpu)}
    frozen = diff.freeze_photon_shoot(scenes[cpu]["photon"], **GRAD_FREEZE)
    frozen_card = diff.freeze_photon_shoot(scenes[device]["photon"], **GRAD_FREEZE)
    for code, entry in frozen.classes.items():
        card = frozen_card.classes[code]
        if (entry is None) != (card is None) or (
                entry is not None and not np.array_equal(entry[0], card[0])):
            raise RuntimeError(f"[30a] the card's frozen shoot differs in class {code}")
    out = {"frozen_photons": {c: 0 if e is None else len(e[0])
                              for c, e in frozen.classes.items()}}
    for name, (which, h, rtol) in GRAD_FD.items():
        fr = frozen if which == "photon" else None
        card_fn = grad_port_losses(scenes[device][which], fr)[name]
        cpu_fn = grad_port_losses(scenes[cpu][which], fr)[name]
        t0 = time.perf_counter()
        g, loss = port_grad(card_fn, device)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        g_cpu, loss_cpu = port_grad(cpu_fn, cpu)
        g_fd = port_fd(card_fn, device, h)
        r = {"grad": g, "loss": loss, "grad_cpu": g_cpu, "loss_cpu": loss_cpu, "grad_fd": g_fd,
             "seconds": sec}
        log(f"  [30a] {name}: d loss / d s = {g:.7g} on the card ({sec:.3f} s), {g_cpu:.7g} on "
            f"the CPU, central difference {g_fd:.7g} (h {h:g}); loss {loss:.7g} / {loss_cpu:.7g}")
        if not (np.isfinite(g) and np.isfinite(g_fd) and g != 0.0):
            raise RuntimeError(f"[30a] {name}: gradient not finite or zero")
        if (abs(g - g_cpu) > GRAD_RTOL * abs(g_cpu)
                or abs(loss - loss_cpu) > GRAD_LOSS_RTOL * abs(loss_cpu)):
            raise RuntimeError(f"[30a] {name}: card and CPU disagree")
        if abs(g - g_fd) > rtol * abs(g_fd) + 1e-6:
            raise RuntimeError(f"[30a] {name}: autograd and central difference disagree")
        if name == "splat" and abs(g - loss) > 1e-4 * abs(loss):
            raise RuntimeError("[30a] splat: photon power is not linear in light power")
        out[name] = r
    return out


def grad_render(scene, ro, kd_scale, max_depth, tile_rays, rr_start=3, want_grad=True):
    """The mean over every camera sample and spectral bin of the path
    tracer's radiance (the render's camera rays and counters), with the
    albedo scale `kd_scale` [M, S]: (loss, d loss / d kd_scale or None).
    Each tile of at most `tile_rays` rays runs forward and backward on its
    own, so the tape holds one tile."""
    import torch
    from pbrt_tpu_torch import diff
    from pbrt_tpu_torch.cameras.cameras import make_camera
    from pbrt_tpu_torch.core.transform import Transform
    from pbrt_tpu_torch.film import film as film_mod
    from pbrt_tpu_torch.integrators.surface import li_path
    from pbrt_tpu_torch.samplers.samplers import camera_samples, make_sampler

    dev = kd_scale.device
    film = film_mod.make_film(ro.film_name, ro.film_params,
                              film_mod.make_filter(ro.filter_name, ro.filter_params), {})
    camera = make_camera(ro.camera_name, ro.camera_params, ro.camera_to_world or Transform(),
                         film.xres, film.yres)
    sampler = make_sampler(ro.sampler_name, ro.sampler_params, {})
    spp = sampler.spp
    n_pix = film.nx * film.ny
    per_tile = max(1, tile_rays // spp)
    norm = 1.0 / (n_pix * spp * S_BINS)
    kd = kd_scale.detach().clone().requires_grad_(want_grad)
    sc = diff.apply_params(scene, diff.DiffParams(kd_scale=kd))
    loss = torch.zeros((), device=dev)
    grad = torch.zeros_like(kd) if want_grad else None
    for p0 in range(0, n_pix, per_tile):
        ids = torch.arange(p0, min(p0 + per_tile, n_pix), device=dev)
        cs = camera_samples(sampler, ids % film.nx + film.x0, ids // film.nx + film.y0,
                            film.xres, 0)
        ray, _ = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
        sidx = torch.arange(spp, dtype=torch.int64, device=dev).repeat(len(ids))
        with torch.set_grad_enabled(want_grad):
            tile = li_path(sc, ray, cs.pixel, sidx, max_depth=max_depth, seed=0,
                           rr_start=rr_start).sum() * norm
        if want_grad:
            grad += torch.autograd.grad(tile, kd)[0]
        loss += tile.detach()
    return float(loss), grad


def phase_grad_small(tmp, device):
    """[30b]: d mean / d kd_scale of the small scene's path trace (K1) at
    GRAD_SMALL_RES^2, 4 spp, depth 5; every K1 launch of the forward
    passes held bit for bit against the plain twin; the gradient against
    central differences along the matte materials' albedo, with Russian
    roulette off (as test_grad.py's depth 2 keeps it off: a survival draw
    flips with the scale), since a matte surface has one lobe and no
    other discrete choice moves with its albedo. -> dict."""
    import torch
    from pbrt_tpu_torch.ops import intersect_cuda

    res, spp, depth, h = GRAD_SMALL_RES, GRAD_SMALL_SPP, 5, 1e-2
    scene, ro = compile_text(small_scene_text(res, spp), "grad_small", tmp, device)
    ones = torch.ones((len(scene.materials), S_BINS), device=device)
    rec = K1Recorder(intersect_cuda.tri_t_pass_cuda, intersect_cuda.tri_t_pass_plain)
    intersect_cuda.launches = 0
    t0 = time.perf_counter()
    with NoPlain(), Patched((intersect_cuda, "tri_t_pass_cuda", rec)):
        loss, g = grad_render(scene, ro, ones, depth, GRAD_TILE_RAYS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = intersect_cuda.launches
    r = rec.summary()
    if launches <= 0 or r["launches"] != launches:
        raise RuntimeError(f"[30b] K1 launches {launches}, checked {r['launches']}")
    if not bool(torch.isfinite(g).all()) or float(g.abs().sum()) == 0.0:
        raise RuntimeError("[30b] gradient not finite or zero")
    # central differences along the matte rows, Russian roulette off
    v = torch.tensor([[1.0 if m.kind == "matte" else 0.0] for m in scene.materials],
                     device=device).expand_as(ones)
    _, g_rr0 = grad_render(scene, ro, ones, depth, GRAD_TILE_RAYS, rr_start=depth)
    ad = float((g_rr0 * v).sum())
    lp, lm = (grad_render(scene, ro, ones + sh * v, depth, GRAD_TILE_RAYS, rr_start=depth,
                          want_grad=False)[0] for sh in (h, -h))
    fd = (lp - lm) / (2.0 * h)
    log(f"  [30b] {res}x{res}, {spp} spp, depth {depth}: loss {loss:.7g}, |grad| sum "
        f"{float(g.abs().sum()):.7g}, {sec:.2f} s with every K1 launch checked; {launches} K1 "
        f"launches bit-equal (kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, bound "
        f"{r['bound_ms']:.4f} ms, live share {r['live_share']:.4f}); along the matte albedo, "
        f"RR off: autograd {ad:.7g}, central difference {fd:.7g} (h {h:g})")
    if not (np.isfinite(fd) and ad != 0.0) or abs(ad - fd) > 2e-2 * abs(fd):
        raise RuntimeError("[30b] autograd and central difference disagree")
    return {"res": res, "spp": spp, "loss": loss, "seconds": sec, "k1_launches": launches,
            "k1": r, "grad_matte_dir": ad, "fd_matte_dir": fd}


def phase_grad_bench(tmp, device):
    """[30c]: bench.py's grad leg: d mean / d kd_scale of the bench
    geometry's path trace at BENCH_RES^2, 1 spp, depth 5, in tiles of
    GRAD_TILE_RAYS rays; CUDA events around every K2 launch. -> dict."""
    import torch
    from pbrt_tpu_torch.ops import bvh_cuda

    scene, ro = compile_text(bench_scene_text(BENCH_RES), "grad_bench", tmp, device)
    ones = torch.ones((len(scene.materials), S_BINS), device=device)
    timer = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    bvh_cuda.launches = 0
    t0 = time.perf_counter()
    with NoPlain(), Patched((bvh_cuda, "wide_sweep", timer)):
        loss, g = grad_render(scene, ro, ones, 5, GRAD_TILE_RAYS)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = bvh_cuda.launches
    peak = torch.cuda.max_memory_allocated(device)
    rays = BENCH_RES * BENCH_RES
    k2_ms = timer.total_ms()
    work = timer.work_rows()
    bound = sum(max(f, b) for f, b in (k2_launch_bound(*w) for w in work))
    log(f"  [30c] {BENCH_RES}x{BENCH_RES}, 1 spp, depth 5, {-(-rays // GRAD_TILE_RAYS)} tiles of "
        f"{GRAD_TILE_RAYS} rays: {sec:.2f} s forward + backward, {rays / sec:.0f} grad rays/s; "
        f"loss {loss:.7g}; K2 {launches} launches, spans {k2_ms:.1f} ms ({k2_ms / 1e3 / sec:.3f} "
        f"of the leg), {sum(w[0] for w in work)} pairs, bound {bound:.3f} ms; peak memory "
        f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the scene)")
    if launches <= 0:
        raise RuntimeError("[30c] the gradient's forward passes did not launch K2")
    if not bool(torch.isfinite(g).all()) or float(g.abs().sum()) == 0.0:
        raise RuntimeError("[30c] gradient not finite or zero")
    return {"res": BENCH_RES, "seconds": sec, "grad_rays_per_s": rays / sec, "loss": loss,
            "k2_launches": launches, "k2_event_ms": k2_ms, "k2_pairs": sum(w[0] for w in work),
            "k2_bound_ms": bound, "peak_bytes": peak, "peak_above_scene_bytes": peak - base}


def run_grad_phases(tmp, device):
    """[30] -> dict."""
    out = {}
    for key, title, fn in (
            ("estimators", "[30a] test_grad.py's four estimators on the card vs the CPU and "
                           "central differences", lambda: phase_grad_estimators(device)),
            ("small", f"[30b] d mean / d kd_scale of the small scene (K1), "
                      f"{GRAD_SMALL_RES}x{GRAD_SMALL_RES}, {GRAD_SMALL_SPP} spp, depth 5",
             lambda: phase_grad_small(tmp, device)),
            ("bench", f"[30c] the grad leg: d mean / d kd_scale of the bench geometry (K2), "
                      f"{BENCH_RES}x{BENCH_RES}, 1 spp, depth 5",
             lambda: phase_grad_bench(tmp, device))):
        log(title)
        t0 = time.perf_counter()
        out[key] = fn()
        log(f"  {title.split()[0]} took {time.perf_counter() - t0:.1f} s")
    return out


# ---------------------------------------------------------------------------
# [31]: process groups on the card (parallel/mesh.py through the CLI)

def dist_scene_text(res, bench=False):
    """tests/test_distributed.py's photonvolume scene at res^2; bench adds
    the bench geometry (K2 in the shoot and the render) with a caustic-free
    quota, so the shoot ends on its indirect and volume photons."""
    s = (f'Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]\n'
         'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
         'LookAt 0 0 -4  0 0 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
         'SurfaceIntegrator "path" "integer maxdepth" [2]\n'
         'VolumeIntegrator "photonvolume" "float stepsize" [1.0]\n'
         '  "integer volumephotons" [100] "integer nused" [10] "float maxdist" [0.8]\n')
    if bench:
        s += '  "integer causticphotons" [0] "integer indirectphotons" [2000]\n'
    s += ('WorldBegin\nLightSource "point" "point from" [0 2 0] "rgb I" [20 20 20]\n'
          'Volume "homogeneous" "point p0" [-1.5 -1.5 -1.5] "point p1" [1.5 1.5 1.5]\n'
          '  "rgb sigma_a" [.05 .05 .05] "rgb sigma_s" [.8 .8 .8]\n')
    if bench:
        P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
        s += ('Material "matte" "rgb Kd" [.45 .35 .65]\n' + mesh(P, idx)
              + 'Material "matte" "rgb Kd" [.55 .55 .5]\n' + mesh(FLOOR, FLOOR_IDX))
    return s + "WorldEnd\n"


class GroupEnv:
    """The JAX package's rendezvous variables for this process (rank
    `pid` of `n` at 127.0.0.1:port) for the length of a with block."""

    KEYS = ("PBRT_COORDINATOR", "PBRT_NUM_PROCESSES", "PBRT_PROCESS_ID")

    def __init__(self, port, n, pid):
        self.values = (f"127.0.0.1:{port}", str(n), str(pid))

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.KEYS}
        os.environ.update(zip(self.KEYS, self.values))

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_render(text, name, tmp, n, extra=()):
    """Rank 0 of an n-rank --distributed render in this process (ranks
    1.. as subprocesses of the CLI, each with its own timeout) ->
    (rank 0's image, seconds, [the other ranks' images], the backend,
    rank 0's collectives and their seconds, the other ranks' counts)."""
    from pbrt_tpu_torch.core import probes
    from pbrt_tpu_torch.io.image import read_image
    from pbrt_tpu_torch.parallel import mesh as pmesh

    port = free_port()
    path = os.path.join(tmp, name + ".pbrt")
    with open(path, "w") as f:
        f.write(text)
    procs = []
    for pid in range(1, n):
        env = dict(os.environ, PYTHONPATH=REPO, PBRT_COORDINATOR=f"127.0.0.1:{port}",
                   PBRT_NUM_PROCESSES=str(n), PBRT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "pbrt_tpu_torch.main", "--distributed", "--verbose", *extra,
             "--outfile", os.path.join(tmp, f"{name}_{pid}.pfm"), path],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    meshes = []
    real_mesh = pmesh.mesh_from_options

    def record(options=None):
        meshes.append(real_mesh(options))
        return meshes[-1]

    probes.reset()
    try:
        with GroupEnv(port, n, 0), Patched((pmesh, "mesh_from_options", record)):
            img, sec = render(text, name + "_0", tmp, ("--distributed", *extra))
        logs = []
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
            if p.returncode != 0:
                raise RuntimeError(f"[31] {name}: a rank failed:\n{logs[-1][-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    counts = probes.counters()
    backends = {m.backend for m in meshes if m is not None}
    if len(backends) != 1 or any(m is None or m.world != n for m in meshes):
        raise RuntimeError(f"[31] {name}: the render did not run over the group ({meshes})")
    others = [int(re.search(r"mesh/collectives\s+([\d,]+)", lg).group(1).replace(",", ""))
              for lg in logs]
    return (img, sec, [read_image(os.path.join(tmp, f"{name}_{pid}.pfm")) for pid in range(1, n)],
            backends.pop(), counts.get("mesh/collectives", 0),
            counts.get("mesh/collective_us", 0) / 1e6, others)


def phase_process_groups(tmp, device):
    """[31]: tests/test_distributed.py's photonvolume scene at DIST_RES^2
    through the CLI: --distributed at world size 1 (NCCL) bit for bit
    against the unsharded card render, and two gloo ranks on the one
    card (rank 1 a subprocess) against it at that test's limits; then
    the scene with the bench geometry at world size 1 (NCCL), K2's
    launches under the group counted, bit for bit. -> dict."""
    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch.ops import bvh_cuda

    extra = ("--tile-samples", str(DIST_RES * DIST_RES))
    out = {}
    with Patched((cli, "GROUP_TIMEOUT_S", 120)):
        single, sec1 = render(dist_scene_text(DIST_RES), "dist_single", tmp, extra)
        img, sec, _, backend, n_coll, coll_s, _ = group_render(
            dist_scene_text(DIST_RES), "dist_nccl", tmp, 1, extra)
        equal = bool(np.array_equal(img, single))
        log(f"  [31] unsharded {sec1:.2f} s; --distributed world 1 ({backend}) {sec:.2f} s, "
            f"{n_coll} collectives in {coll_s:.3f} s; bit-equal to the unsharded render: {equal}")
        if backend != "nccl" or not equal:
            raise RuntimeError("[31] the NCCL world-1 render is not the unsharded render")
        out["nccl_world1"] = {"seconds": sec, "single_seconds": sec1, "collectives": n_coll,
                              "collective_seconds": coll_s}
        img, sec, (img1,), backend, n_coll, coll_s, others = group_render(
            dist_scene_text(DIST_RES), "dist_gloo", tmp, 2, extra)
        d_single = float(np.abs(img - single).max())
        d_ranks = float(np.abs(img - img1).max())
        log(f"  [31] two {backend} ranks on one card: {sec:.2f} s (rank 0, rank 1 a subprocess), "
            f"rank 0 {n_coll} collectives in {coll_s:.3f} s, rank 1 {others[0]}; max |diff| "
            f"vs unsharded {d_single:.3g}, between the ranks {d_ranks:.3g}")
        if (backend != "gloo" or not np.allclose(img, single, rtol=1e-4, atol=1e-5)
                or not np.allclose(img, img1, rtol=1e-5, atol=1e-7)):
            raise RuntimeError("[31] the two-rank render disagrees")
        out["gloo_two_ranks"] = {"seconds": sec, "collectives": n_coll,
                                 "collective_seconds": coll_s, "rank1_collectives": others[0],
                                 "max_diff_single": d_single, "max_diff_ranks": d_ranks}
        bvh_cuda.launches = 0
        single, sec1 = render(dist_scene_text(DIST_RES, bench=True), "distb_single", tmp, extra)
        k2_single = bvh_cuda.launches
        bvh_cuda.launches = 0
        img, sec, _, backend, n_coll, coll_s, _ = group_render(
            dist_scene_text(DIST_RES, bench=True), "distb_nccl", tmp, 1, extra)
        k2 = bvh_cuda.launches
        equal = bool(np.array_equal(img, single))
        log(f"  [31] with the bench geometry: unsharded {sec1:.2f} s ({k2_single} K2 launches); "
            f"world 1 ({backend}) {sec:.2f} s, {k2} K2 launches, {n_coll} collectives in "
            f"{coll_s:.3f} s; bit-equal: {equal}")
        if k2 <= 0 or k2 != k2_single or not equal:
            raise RuntimeError("[31] the bench geometry's group render differs or ran no K2")
        out["bench_nccl_world1"] = {"seconds": sec, "single_seconds": sec1, "k2_launches": k2,
                                    "collectives": n_coll, "collective_seconds": coll_s}
    return out


def bvh_invariants(tree, lo, hi):
    """The checks of tests/test_tools.py:91-108 on a binary tree over the
    boxes lo/hi [P, 3]: the leaves name every primitive exactly once, and
    each leaf's primitives lie inside its box (1e-4 slack) -> leaves."""
    node_lo, node_hi, meta, order = (np.asarray(x) for x in tree)
    n = len(lo)
    if not np.array_equal(np.sort(order), np.arange(n)):
        raise RuntimeError("BVH: the leaf order is not a permutation of the primitives")
    leaves = np.nonzero(meta[:, 1] > 0)[0]
    counts = meta[leaves, 1].astype(np.int64)
    first = np.repeat(meta[leaves, 0].astype(np.int64), counts)
    pos = first + np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
    if not np.array_equal(np.sort(pos), np.arange(n)):
        raise RuntimeError("BVH: the leaves do not name every primitive exactly once")
    owner = np.repeat(leaves, counts)
    pid = order[pos]
    inside = (lo[pid] >= node_lo[owner] - 1e-4) & (hi[pid] <= node_hi[owner] + 1e-4)
    if not inside.all():
        raise RuntimeError(f"BVH: {int((~inside.all(-1)).sum())} primitives outside their "
                           "leaf's box")
    return len(leaves)


def phase_fallback_trees(tmp, device):
    """[32] The Python BVH builders (accel/bvh.py's fallback when the
    native builder cannot be built) on the bench geometry: the native
    builder is refused in this process (its loader raises the error a
    failed g++ raises), and make_accel builds the "sah" and "aac" trees
    in Python; each tree's invariants; the camera rays of one
    FALLBACK_RES^2 view through each wide tree with K2 (the main path's
    t-pass, plain twins refused; counted), again with every wave held
    bit for bit against the plain twin, and against the same rays
    through the native tree: prim equal on >= FALLBACK_AGREE of the
    rays, and t bit-equal on every ray (so a prim differs only at an
    exact tie of t)."""
    import torch
    from pbrt_tpu_torch.accel import bvh
    from pbrt_tpu_torch.core.error import PbrtError
    from pbrt_tpu_torch.core.geometry import Ray
    from pbrt_tpu_torch.ops import bvh_cuda

    scene, _ = compile_text(bench_scene_text(FALLBACK_RES), "fallback", tmp, device)
    geom = scene.geom
    lo, hi = bvh.prim_bounds(geom)
    world = (geom.world_lo.cpu().numpy(), geom.world_hi.cpu().numpy())
    # the native builds, its library loaded by the compile
    native_s = {m: host_s(lambda: bvh.build_bvh_bounds(lo, hi, m, world))[1]
                for m in ("sah", "aac")}

    n = FALLBACK_RES * FALLBACK_RES
    xs = np.linspace(-0.55, 0.55, FALLBACK_RES, dtype=np.float32)
    gx, gy = np.meshgrid(xs, xs[::-1], indexing="xy")
    d = np.stack([gx.ravel(), gy.ravel() + 0.18, np.ones(n, np.float32)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray = Ray(torch.as_tensor(np.tile([[0.0, 1.2, -4.0]], (n, 1)).astype(np.float32),
                              device=device),
              torch.as_tensor(d, device=device), torch.zeros(n, device=device),
              torch.full((n,), float("inf"), device=device), torch.zeros(n, device=device))
    with NoPlain():
        t_nat, p_nat = scene.accel._t_pass(ray, coherent=True)

    def refuse():
        raise PbrtError("g++ failed building the BVH builder:\n(refused by chip_smoke.py)")

    out = {"rays": n, "k2_launches": 0}
    for method in ("sah", "aac"):
        timer = BuildTimer(bvh.build_bvh)
        with Patched((bvh, "_load_native", refuse), (bvh, "build_bvh", timer)):
            accel, make_s = host_s(lambda: bvh.make_accel(geom, method))
        leaves = bvh_invariants(timer.last, lo, hi)
        bvh_cuda.launches = 0
        with NoPlain():
            (t, p), trav_s = host_s(lambda: accel._t_pass(ray, coherent=True))
        launches = bvh_cuda.launches
        if launches <= 0:
            raise RuntimeError(f"[32] {method}: the traversal did not launch K2")
        out["k2_launches"] += launches
        rec, t_chk, p_chk = traverse(bvh_cuda, accel.wide, ray.o, ray.d, ray.tmin, ray.tmax, n,
                                     coherent=True)
        r = rec.summary()
        if r["t_bits_differ"]:
            raise RuntimeError(f"[32] {method}: K2 t bits differ from the plain twin on "
                               f"{r['t_bits_differ']} rays")
        compare(f"[32] {method}: the counted traversal vs the checked one", t, p, t_chk, p_chk,
                bits=True)
        same = p == p_nat
        share = float(same.float().mean())
        t_differ = int((t.view(torch.int32) != t_nat.view(torch.int32)).sum())
        if share < FALLBACK_AGREE or t_differ:
            raise RuntimeError(f"[32] {method}: prim agrees with the native tree's on "
                               f"{share:.6f} of the rays (need {FALLBACK_AGREE}); t bits "
                               f"differ on {t_differ} rays")
        hits = int((p >= 0).sum())
        out[method] = {"python_build_s": timer.seconds[-1], "native_build_s": native_s[method],
                       "make_accel_s": make_s, "nodes": int(timer.last.n_nodes),
                       "leaves": leaves, "leaf_blocks": int(accel.wide.n_blocks),
                       "k2_launches": launches, "traversal_s": trav_s, "hits": hits,
                       "prim_agree_share": share, "prim_differ_at_ties": int((~same).sum()),
                       **{k: r[k] for k in ("waves", "pairs", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "max_abs_err")}}
        log(f"  {method}: Python build {timer.seconds[-1]:.2f} s, {timer.last.n_nodes} nodes, "
            f"{leaves} leaves (native build {native_s[method]:.3f} s), invariants hold; "
            f"make_accel {make_s:.2f} s, {accel.wide.n_blocks} leaf blocks; traversal "
            f"{trav_s:.3f} s, {launches} K2 launches, {hits} hits; checked: {r['waves']} "
            f"waves, {r['pairs']} pairs, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} "
            f"ms, bound {r['bound_ms']:.3f} ms ({r['bound_by']}), every wave bit-equal; prim "
            f"as the native tree's on {share:.6f} of {n} rays ({int((~same).sum())} ties), "
            f"t bit-equal on every ray")
    return out


def run_cli(scene_text, out_name, tmp, extra=()):
    """Write the scene and run it through the CLI entry point -> seconds."""
    from pbrt_tpu_torch import main as cli

    path = os.path.join(tmp, out_name + ".pbrt")
    with open(path, "w") as f:
        f.write(scene_text)
    t0 = time.perf_counter()
    rc = cli.main(["--quiet", *extra, path])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"render of {out_name} failed (rc {rc})")
    return seconds


def render(scene_text, out_name, tmp, extra=()):
    """Write the scene and render it through the CLI entry point."""
    from pbrt_tpu_torch.io.image import read_image

    out = os.path.join(tmp, out_name + ".pfm")
    seconds = run_cli(scene_text, out_name, tmp, ("--outfile", out, *extra))
    img = read_image(out)
    if not np.all(np.isfinite(img)) or not img.mean() > 0:
        raise RuntimeError(f"{out_name}: image not finite or black (mean {img.mean()})")
    return img, seconds


def run_photon_phases(tmp, device):
    """[11]-[13], the photon scenes and legs -> dict."""
    log("[11] rainbowc (photonmap + final gather, photonvolume in a rainbow region, distant "
        "light; imagemap x scale walls)")
    rainbowc = phase_rainbowc(tmp)
    log("[12] photon legs (bench.py): scattering cube + point light")
    legs = phase_photon_legs(tmp, device)
    log(f"[13] benchphoton (bench geometry + glass sphere, spot + point light in a "
        f"homogeneous box; photonmap with final gather, photonvolume, 1M volume photons)")
    t0 = time.perf_counter()
    benchphoton = phase_benchphoton(tmp, device)
    log(f"  [13] took {time.perf_counter() - t0:.1f} s")
    return {"rainbowc": rainbowc, "photon_legs": legs, "benchphoton": benchphoton}


def run_texture_phases(tmp):
    """[14]-[15], the textured scenes -> dict."""
    log(f"[14] benchtex (bench geometry; mix of marble substrate and copper, uber floor with "
        f"an image map, dots and a wrinkled bump; path maxdepth 5) {BENCHTEX_RES}x"
        f"{BENCHTEX_RES}, 1 spp")
    t0 = time.perf_counter()
    benchtex = phase_benchtex(tmp)
    log(f"  [14] took {time.perf_counter() - t0:.1f} s")
    log(f"[15] small textured scene (translucent, shinymetal, kdsubsurface, measured, imagemap "
        f"plastic with an fbm bump, alpha-masked quad), card vs CPU")
    t0 = time.perf_counter()
    smalltex = phase_smalltex(tmp)
    log(f"  [15] took {time.perf_counter() - t0:.1f} s")
    return {"benchtex": benchtex, "smalltex": smalltex}


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        raise RuntimeError("torch is not installed")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this smoke test runs on a GPU")
    if not os.path.isdir(os.path.join(REPO, "pbrt_tpu_torch")):
        raise RuntimeError("pbrt_tpu_torch/ not found: run chip_smoke.py from the repo root")
    sys.path.insert(0, REPO)
    device = torch.device("cuda", 0)

    card = card_line()
    log(f"[1] device: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from pbrt_tpu_torch.ops import build

    build.load_kernels()
    log(f"[2] kernels: {'cached' if build.BuildInfo.cached else 'built'} "
        f"{build.BuildInfo.path} from pbrt_tpu_torch/csrc/*.cu for sm_90a in "
        f"{build.BuildInfo.seconds:.1f} s")
    for line in build.BuildInfo.ptxas.splitlines():
        if ("ptxas" in line and ("Used" in line or "Compiling" in line)) or "spill" in line:
            log("  " + line.strip())
    sass = sass_inner_loops(build.BuildInfo.path)
    if not sass:
        log("  inner-loop instruction counts: not measured (no cuobjdump)")
    for fn, c in sass.items():
        log(f"  SASS inner loop of {fn}: {c['instructions']} instructions for {c['tests']} "
            f"tests = {c['per_test']:.2f} per test {c['by_class']}; {c['slow_path']} of them "
            f"call the division's slow path, so {c['per_test_fast']:.2f} per test on the fast "
            f"path; ceiling under the rounding contract {MT_FLOPS} / (2 x "
            f"{c['per_test_fast']:.2f}) = {c['ceiling']:.1%} of the FLOP bound")

    log("[3] K1 (flat t-pass) vs plain torch")
    k1 = phase_k1(device)
    log("[4] K2 (wide-leaf sweep) vs plain torch at the bench geometry")
    k2 = phase_k2(device)

    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    with tempfile.TemporaryDirectory() as tmp:
        # the main path: counts reset just before each render, read just after
        intersect_cuda.launches = 0
        bvh_cuda.launches = 0
        log(f"[5] bench render {BENCH_RES}x{BENCH_RES}, 1 spp, maxdepth 5")
        img, sec = render(bench_scene_text(BENCH_RES), "bench", tmp)
        k2["launches"] = bvh_cuda.launches
        log(f"  {sec:.2f} s end to end (parse + compile + BVH build + render), "
            f"{BENCH_RES * BENCH_RES / sec:.0f} camera rays/s, image mean {img.mean():.5f}, "
            f"K2 launches {k2['launches']}")
        if k2["launches"] <= 0:
            raise RuntimeError("bench render did not launch K2")
        intersect_cuda.launches = 0
        bvh_cuda.launches = 0
        log(f"[6] small render {SMALL_RES}x{SMALL_RES}, 4 spp (matte, plastic, mirror, "
            "glass Vn, triangle area light)")
        img, sec_small = render(small_scene_text(SMALL_RES, 4), "small", tmp)
        k1_launches = intersect_cuda.launches
        log(f"  {sec_small:.2f} s end to end, image mean {img.mean():.5f}, "
            f"K1 launches {k1_launches}")
        if k1_launches <= 0:
            raise RuntimeError("small render did not launch K1")

        # outside the timed render: every K1 launch of a small render held
        # against the plain twin, then K1's time inside a render by events
        log("[6b] small render again, every K1 launch vs plain torch (bit for bit)")
        rec = K1Recorder(intersect_cuda.tri_t_pass_cuda, intersect_cuda.tri_t_pass_plain)
        real_k1 = intersect_cuda.tri_t_pass_cuda
        try:
            intersect_cuda.tri_t_pass_cuda = rec
            render(small_scene_text(SMALL_RES, 4), "small_checked", tmp)
        finally:
            intersect_cuda.tri_t_pass_cuda = real_k1
        r = rec.summary()
        if r["launches"] != k1_launches:
            raise RuntimeError(f"K1 launches differ between renders: {r['launches']} vs "
                               f"{k1_launches}")
        log(f"  {r['launches']} launches, {r['rays']} rays, live share {r['live_share']:.4f} "
            f"(per launch {r['live_share_per_launch']}), {r['hits']} hits; every launch: prim "
            f"identical, t bit-equal; kernel {r['ms']:.3f} ms, plain torch {r['plain_ms']:.3f} "
            f"ms; bound over live rays {r['bound_ms']:.3f} ms ({r['bound_by']}), "
            f"{r['bound_ms'] / r['ms']:.1%} of bound; over all rays {r['bound_all_rays_ms']:.3f}"
            f" ms, {r['bound_all_rays_ms'] / r['ms']:.1%}")
        log("[6c] small render again, CUDA events around every K1 launch")
        timer = LaunchTimer(real_k1)
        try:
            intersect_cuda.tri_t_pass_cuda = timer
            _, sec_ev = render(small_scene_text(SMALL_RES, 4), "small_events", tmp)
        finally:
            intersect_cuda.tri_t_pass_cuda = real_k1
        k1_render_ms = timer.total_ms()
        log(f"  {sec_ev:.2f} s end to end (timed render {sec_small:.2f} s); K1 "
            f"{k1_render_ms:.3f} ms over {len(timer.events)} launches (event spans)")
        k1_set3 = k1
        k1 = {"launches": k1_launches, "max_abs_err": 0.0,
              **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "bound_all_rays_ms", "live_share", "tests")},
              "small_render": {"seconds": sec_small, "seconds_with_events": sec_ev,
                               "k1_event_ms": k1_render_ms,
                               "live_share_per_launch": r["live_share_per_launch"]},
              "set3": k1_set3, "sass": sass_of(sass, "k1_sweep_kernel", "tri_t_pass_kernel")}

        # outside the timed render: K2's share of a bench render, by events
        log("[5b] bench render again, CUDA events around every K2 launch")
        timer = LaunchTimer(bvh_cuda.wide_sweep_cuda, work=k2_work)
        real_sweep = bvh_cuda.wide_sweep
        try:
            bvh_cuda.wide_sweep = timer
            _, sec_ev = render(bench_scene_text(BENCH_RES), "bench_events", tmp)
        finally:
            bvh_cuda.wide_sweep = real_sweep
        k2_render_ms = timer.total_ms()
        n_ev = max(len(timer.events), 1)
        per_launch = [k2_launch_bound(*w) for w in timer.work_rows()]
        f_ms = sum(f for f, _ in per_launch)
        b_ms = sum(max(f, b) for f, b in per_launch)
        pairs = sum(w[0] for w in timer.work_rows())
        k2["bench_render"] = {"seconds": sec, "seconds_with_events": sec_ev,
                              "k2_event_ms": k2_render_ms, "k2_launches": len(timer.events),
                              "pairs": pairs, "bound_ms": b_ms, "flops_bound_ms": f_ms,
                              "bound_ms_per_launch": b_ms / n_ev}
        log(f"  {sec_ev:.2f} s end to end (timed render {sec:.2f} s); K2 {k2_render_ms:.1f} ms "
            f"over {len(timer.events)} launches ({k2_render_ms / n_ev:.4f} ms per launch, "
            f"event span); {pairs} (tile, block) pairs, bound {b_ms:.3f} ms "
            f"({b_ms / n_ev:.5f} ms per launch; operations alone {f_ms:.3f} ms), "
            f"{b_ms / k2_render_ms:.1%} of the event spans")
        if "--profile" in sys.argv[1:]:
            log("[5c] bench render under torch.profiler")
            k2["bench_render"]["profile"] = profile_render(bench_scene_text(BENCH_RES), tmp)

        # the card path against the CPU path (plain twins) on a small input
        log("[7] small render 32x32 on the card vs on the CPU")
        text = small_scene_text(32, 4)
        gpu, _ = render(text, "check_gpu", tmp, extra=("--tile-samples", "4096"))
        cpu, _ = render(text, "check_cpu", tmp,
                        extra=("--tile-samples", "4096", "--device", "cpu"))
        agree(gpu, cpu, "small 32x32")
        log(f"[8] phases [1]-[7] passed in {time.perf_counter() - t_start:.1f} s")

        log("[9] the reference-binary goldens on the card (authored size and spp)")
        goldens = phase_goldens(tmp)
        log(f"[10] benchvol (bench geometry + glass sphere + disk light + homogeneous "
            f"volume; directlighting maxdepth 5, single scattering, 16 march steps)")
        benchvol = phase_benchvol(tmp)
        photon = run_photon_phases(tmp, device)
        textured = run_texture_phases(tmp)
        sliced = run_slice_phases(tmp)
        longtail = run_longtail_phases(tmp)
        mlt = run_mlt_phases(tmp)
        log("[30] gradients on the card (pbrt_tpu_torch/diff.py)")
        t0 = time.perf_counter()
        grad = run_grad_phases(tmp, device)
        log(f"  [30] took {time.perf_counter() - t0:.1f} s")
        log(f"[31] process groups on the card (parallel/mesh.py through the CLI): "
            f"tests/test_distributed.py's scene at {DIST_RES}x{DIST_RES}")
        t0 = time.perf_counter()
        groups = phase_process_groups(tmp, device)
        log(f"  [31] took {time.perf_counter() - t0:.1f} s")
        log(f"[32] the Python BVH builders on the card's main path: the bench geometry's "
            f"sah and aac trees with the native builder refused, K2 over "
            f"{FALLBACK_RES}x{FALLBACK_RES} camera rays")
        t0 = time.perf_counter()
        fallback = phase_fallback_trees(tmp, device)
        log(f"  [32] took {time.perf_counter() - t0:.1f} s")

    # K1: every launch of the small render, the goldens, rainbowc, the
    # small textured scene, [17], [18], [24], [25], [26a], [26b] and [29]
    # (set3: 65,536 rays x 4,096 triangles); K2: the three 1024^2 ray
    # sets in the render's 65,536-ray traversals (sums over every wave;
    # by_set has each set at both shapes), launches of the bench,
    # benchvol, benchphoton, benchtex, benchenv, benchlens, benchirr and
    # benchmlt renders. No single PyTorch call computes either.
    k1["goldens"] = goldens
    k1["rainbowc"] = photon["rainbowc"]
    k1["smalltex"] = textured["smalltex"]
    k1["smalllights"] = sliced["smalllights"]
    k1["samplers"] = sliced["samplers"]
    k1["longtail"] = longtail["longtail"]
    k1["autofocus"] = longtail["autofocus"]
    lt_k1 = (sum(r["k1_launches"] for k, r in longtail["longtail"].items()
                 if not k.startswith("files_")) + longtail["autofocus"]["k1_launches"])
    k1["mlt"] = {"paths_small": mlt["mlt"]["paths_small"], "small": mlt["mlt"]["small"],
                 "obj": mlt["tools"]}
    lt_k1 += (mlt["mlt"]["paths_small"]["k1"]["launches"] + mlt["mlt"]["small"]["k1_launches"]
              + mlt["tools"]["k1_launches"])
    k1["launches"] += (sum(g["k1_launches"] for g in goldens.values())
                       + photon["rainbowc"]["k1_launches"] + textured["smalltex"]["k1_launches"]
                       + sliced["smalllights"]["k1_launches"]
                       + sum(r["k1_launches"] for r in sliced["samplers"].values()) + lt_k1)
    k2["benchvol"] = benchvol
    k2["benchphoton"] = photon["benchphoton"]
    k2["benchtex"] = textured["benchtex"]
    k2["benchenv"] = sliced["benchenv"]
    k2["benchlens"] = longtail["benchlens"]
    k2["benchirr"] = longtail["benchirr"]
    k2["benchmlt"] = mlt["mlt"]["benchmlt"]
    k2["mlt_paths_bench"] = mlt["mlt"]["paths_bench"]
    k2["launches"] += (benchvol["k2_launches"] + photon["benchphoton"]["k2_launches"]
                       + textured["benchtex"]["k2_launches"] + sliced["benchenv"]["k2_launches"]
                       + longtail["benchlens"]["k2_launches"]
                       + longtail["benchirr"]["k2_launches"]
                       + mlt["mlt"]["benchmlt"]["spans"]["k2_launches"])
    # [30b] and [30c]: the launches of the gradients' forward passes
    # (inside autograd); [31]: K2 under a process group
    k1["grad"] = grad["small"]
    k1["launches"] += grad["small"]["k1_launches"]
    k2["grad"] = grad["bench"]
    k2["process_group"] = groups["bench_nccl_world1"]
    k2["launches"] += grad["bench"]["k2_launches"] + groups["bench_nccl_world1"]["k2_launches"]
    # [32]: K2 over the trees of the Python builders
    k2["fallback_trees"] = fallback
    k2["launches"] += fallback["k2_launches"]
    log(f"  gradient estimators: {json.dumps(grad['estimators'], default=float)}")
    log(f"  process groups: {json.dumps(groups, default=float)}")
    log(f"  photon legs: {json.dumps(photon['photon_legs'])}")
    log(f"  motion: {json.dumps(sliced['motion'], default=float)}; checkpoint: "
        f"{json.dumps(sliced['checkpoint'])}")
    log(f"  goldens irr / dprt: {json.dumps(longtail['goldens'], default=float)}")
    log(f"  grid / kd-tree: {json.dumps(mlt['accels'], default=float)}; aggregatetest: "
        f"{json.dumps(mlt['aggtest'], default=float)}")
    log(f"  all phases passed in {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {"name": "k1_sweep_kernel", "route": "cuda",
         "source": "pbrt_tpu_torch/csrc/intersect.cu",
         "replaces": "pbrt_tpu/ops/intersect_pallas.py:35", "library_ms": None, **k1},
        {"name": "k2_sweep_kernel", "route": "cuda",
         "source": "pbrt_tpu_torch/csrc/bvh_sweep.cu",
         "replaces": "pbrt_tpu/ops/bvh_pallas.py:54", "library_ms": None,
         "sass": sass_of(sass, "k2_sweep_kernel"), **k2},
    ]
    print(json.dumps({"kernels": kernels}, default=lambda x: x.item()))  # NumPy scalars
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # report and fail: no result line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
