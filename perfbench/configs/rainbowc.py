"""rainbowc: the CS348B rainbow shot, tests/goldens/rainbowc.pbrt as a scene
of its own.

Three matte walls under an imagemap x scale texture (the image, missing
upstream too, reads as one white texel), one distant light, one
`rainbow` volume box, `photonmap` (final gather, no caustic or indirect
photons) as the surface integrator and `photonvolume` (5,000 volume
photons, stepsize .15) as the volume integrator, the lowdiscrepancy
sampler and the gaussian filter. The numbers are in rainbowc.json beside
this file. The scene goes to the renderer through its scene API (no
scene text is parsed), and the same numbers to the plain reference
(perfbench/reference/rainbow.py).

What the harness asks of a configuration's module: `emit_scene` (the
scene through the renderer's API), `reference` (the plain reference
that renders pixels of the window's frames for the check) and `compare`
(the check's numbers).

The check holds the photon shoot too, which takes most of a frame and
which the image does not read. `emit_scene` wraps the renderer's
`build_photon_maps` in a recorder that keeps, for each frame seed, the
counts and the volume map of that frame's shoot (device tensors: no
device read in the window). The reference's pixels carry, as the
attribute `photons`, the numbers of the frames' recorded shoots against
the plain reference shooter (perfbench/reference/rainbow_shoot.py), and
`compare` adds them to the pixels' numbers:

- `photon_count_rel_diff`: the largest relative difference of a frame's
  stored volume or direct photons;
- `volume_power_rel_diff`: the largest relative difference of a frame's
  volume map power (every photon's, every bin's, over the paths shot);
- `volume_mean_pos_diff`: the largest difference of a coordinate of a
  frame's volume photons' mean position (world units).

A frame whose shoot was not recorded reads inf on all three.
"""
from __future__ import annotations

import math
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SHOOTER = "pbrt_tpu_torch.photon.shooter"
KEEP_SHOOTS = 32          # the recorder keeps the last frames' shoots
PHOTON_NUMBERS = ("photon_count_rel_diff", "volume_power_rel_diff", "volume_mean_pos_diff")


def _rotate(deg, axis):
    """pbrt-v2's Rotate (core/transform.cpp) as a 4 x 4 matrix."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    s, c = math.sin(math.radians(deg)), math.cos(math.radians(deg))
    m = np.eye(4)
    m[:3, :3] = (np.outer(a, a) * (1 - c) + c * np.eye(3)
                 + s * np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]))
    return m


def _translate(v):
    m = np.eye(4)
    m[:3, 3] = v
    return m


def _scale(v):
    return np.diag([*v, 1.0])


def transforms(cfg: dict):
    """-> (world-to-camera, the world block's transform at the volume and
    the light, the walls' transform), as pbrt-v2 composes the scene's
    Rotate / Translate / Scale statements."""
    cam = cfg["camera"]
    world_to_camera = _rotate(cam["rotate"][0], cam["rotate"][1:]) @ _translate(cam["translate"])
    world = _translate(cfg["world_translate"])
    walls = world @ _translate(cfg["walls"]["translate"]) @ _scale(cfg["walls"]["scale"])
    return world_to_camera, world, walls


class ShootRecorder:
    """Stands in for the renderer's `build_photon_maps`: calls it and keeps
    what the frame's shoot stored, by the frame's seed."""

    def __init__(self, build):
        self.build, self.shoots = build, {}

    def __call__(self, scene, surf_params, vol_params, options=None):
        ctx = self.build(scene, surf_params, vol_params, options)
        seed = int((options or {}).get("seed", 0))
        vol = ctx.volume
        self.shoots.pop(seed, None)
        stats = ctx.stats
        self.shoots[seed] = (dict(stats.get("counts", {})), stats.get("batches", 0),
                             stats.get("shots", 0), None if vol is None else (vol.pos, vol.alpha))
        while len(self.shoots) > KEEP_SHOOTS:
            self.shoots.pop(next(iter(self.shoots)))
        return ctx

    def shoot(self, seed: int):
        """The recorded shoot of the frame with this seed as a
        rainbow_shoot.Shoot, None where none was recorded."""
        from perfbench.reference.rainbow_shoot import Shoot

        if seed not in self.shoots:
            return None
        counts, batches, shots, vol = self.shoots[seed]

        def n(name):
            return int(counts.get(name, [0])[0])

        power, mean = 0.0, np.full(3, np.nan)
        if vol is not None:
            pos, alpha = vol
            power = float(alpha.double().sum())
            mean = pos.double().mean(0).cpu().numpy()
        return Shoot(batches=int(batches), shots=int(shots), volume=n("volume"), direct=n("direct"),
                     indirect=n("indirect"), volume_power=power, volume_mean_pos=mean)


def install_recorder():
    """Wraps the renderer's `build_photon_maps` once -> the recorder."""
    import importlib

    shooter = importlib.import_module(SHOOTER)
    if not hasattr(shooter.build_photon_maps, "shoots"):
        shooter.build_photon_maps = ShootRecorder(shooter.build_photon_maps)
    return shooter.build_photon_maps


def recorder():
    """The recorder `emit_scene` installed, None where there is none."""
    build = getattr(sys.modules.get(SHOOTER), "build_photon_maps", None)
    return build if hasattr(build, "shoots") else None


def emit_scene(api, ParamSet, cfg: dict, work: dict):
    """The scene through the renderer's API, up to WorldEnd: film and
    sampler from the workload, the rest from the configuration, in the
    order of tests/goldens/rainbowc.pbrt. Installs the shoot's recorder
    first."""
    install_recorder()

    def params(*items):
        ps = ParamSet(search_dir=HERE)     # no textures/ here: the image is missing
        for kind, name, values in items:
            ps.add(kind, name, values)
        return ps

    api.pbrt_film("image", params(("integer", "xresolution", [work["xres"]]),
                                  ("integer", "yresolution", [work["yres"]])))
    api.pbrt_sampler(cfg["sampler"], params(("integer", "pixelsamples", [work["spp"]])))
    api.pbrt_pixel_filter(cfg["filter"], params())
    si = cfg["surface_integrator"]
    api.pbrt_surface_integrator(si["name"], params(
        ("integer", "nused", [si["nused"]]), ("bool", "finalgather", [si["finalgather"]]),
        ("integer", "finalgathersamples", [cfg["finalgathersamples"]]),
        ("float", "maxdist", [si["maxdist"]]),
        ("integer", "indirectphotons", [si["indirectphotons"]]),
        ("integer", "causticphotons", [si["causticphotons"]])))
    vi = cfg["volume_integrator"]
    api.pbrt_volume_integrator(vi["name"], params(
        ("float", "stepsize", [vi["stepsize"]]), ("integer", "nused", [vi["nused"]]),
        ("float", "maxdist", [vi["maxdist"]]),
        ("integer", "volumephotons", [vi["volumephotons"]])))
    cam = cfg["camera"]
    api.pbrt_rotate(*cam["rotate"])
    api.pbrt_translate(*cam["translate"])
    api.pbrt_camera("perspective", params(("float", "fov", [cam["fov"]])))
    api.pbrt_world_begin()
    api.pbrt_translate(*cfg["world_translate"])
    vol = cfg["volume"]
    api.pbrt_volume(vol["kind"], params(("color", "sigma_a", vol["sigma_a"]),
                                        ("color", "sigma_s", vol["sigma_s"]),
                                        ("point", "p0", vol["p0"]), ("point", "p1", vol["p1"])))
    light = cfg["light"]
    api.pbrt_light_source(light["kind"], params(("point", "from", light["from"]),
                                                ("point", "to", light["to"]),
                                                ("color", "L", light["L"])))
    walls = cfg["walls"]
    api.pbrt_translate(*walls["translate"])
    api.pbrt_scale(*walls["scale"])
    tex = walls["texture"]
    api.pbrt_texture("grid", "color", "imagemap", params(("string", "filename", [tex["image"]])))
    api.pbrt_texture("sgrid", "color", "scale", params(("texture", "tex1", ["grid"]),
                                                       ("color", "tex2", tex["scale"])))
    api.pbrt_material("matte", params(("texture", "Kd", ["sgrid"])))
    for quad in walls["quads"]:
        api.pbrt_shape("trianglemesh", params(("integer", "indices", walls["indices"]),
                                              ("point", "P", quad),
                                              ("float", "uv", walls["uv"])))


def reference_scene(cfg: dict):
    """The same scene for the plain reference (perfbench/reference)."""
    from perfbench.reference.rainbow import RainbowScene

    world_to_camera, world, walls = transforms(cfg)
    idx = np.asarray(cfg["walls"]["indices"]).reshape(-1, 3)
    uv = np.asarray(cfg["walls"]["uv"], np.float64).reshape(-1, 2)
    tris = []
    for quad in cfg["walls"]["quads"]:
        P = np.asarray(quad, np.float64).reshape(-1, 3)
        Pw = P @ walls[:3, :3].T + walls[:3, 3]
        tris.append(Pw[idx])
    light, vol = cfg["light"], cfg["volume"]
    to_light = np.asarray(light["from"], np.float64) - np.asarray(light["to"], np.float64)
    return RainbowScene(
        tris=np.concatenate(tris),
        kd_factors=((1.0, 1.0, 1.0), tuple(cfg["walls"]["texture"]["scale"])),
        light_dir=world[:3, :3] @ (to_light / np.linalg.norm(to_light)),
        light_rgb=np.asarray(light["L"], np.float64),
        w2v=np.linalg.inv(world),
        box_lo=np.minimum(vol["p0"], vol["p1"]), box_hi=np.maximum(vol["p0"], vol["p1"]),
        sigma_a_rgb=np.asarray(vol["sigma_a"], np.float64),
        sigma_s_rgb=np.asarray(vol["sigma_s"], np.float64),
        cam_to_world=np.linalg.inv(world_to_camera),
        fov=float(cfg["camera"]["fov"]),
        stepsize=float(cfg["volume_integrator"]["stepsize"]),
        tri_uv=np.concatenate([uv[idx]] * len(tris)))


class CheckedRGB(np.ndarray):
    """The reference's pixels, with the photon numbers of their frames."""

    photons: dict = None


def photon_numbers(prog: list, ref: list) -> dict:
    """The shoot's numbers (module docstring) of frames' shoots `prog`
    against `ref` (rainbow_shoot.Shoot each; None in `prog` where a frame's
    shoot was not recorded)."""
    if not ref or any(p is None for p in prog):
        return dict.fromkeys(PHOTON_NUMBERS, math.inf)
    count = [abs(getattr(p, k) - getattr(r, k)) / max(getattr(r, k), 1)
             for p, r in zip(prog, ref) for k in ("volume", "direct")]
    power = [abs(p.volume_power - r.volume_power) / max(abs(r.volume_power), 1e-30)
             for p, r in zip(prog, ref)]
    pos = [np.abs(p.volume_mean_pos - r.volume_mean_pos).max() for p, r in zip(prog, ref)]
    return dict(zip(PHOTON_NUMBERS, (float(np.max(v)) for v in (count, power, pos))))


def reference_shooter(cfg: dict, dtype, device):
    """The plain reference shooter of this configuration."""
    from perfbench.reference.rainbow_shoot import Shooter

    return Shooter(reference_scene(cfg), cfg["volume_integrator"]["volumephotons"], dtype=dtype,
                   device=device, chunk=16 if str(device).startswith("cuda") else 4)


def reference(cfg: dict, traffic: dict, dtype, device):
    """The plain reference of this configuration at the cell's film:
    `render(frames, fi, x, y)` -> linear RGB [N, 3] of pixels (x, y) of
    frames fi (every frame seen from the scene's own camera), a
    CheckedRGB whose `photons` hold the frames' recorded shoots against
    the reference shooter's."""
    import torch
    from perfbench.reference.rainbow import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(reference_scene(cfg), traffic["xres"], traffic["yres"], traffic["spp"],
                    int(traffic["tile_samples"]), dtype=dtype, device=device)
    shoot = reference_shooter(cfg, dtype, device)

    def render(frames, fi, x, y):
        rgb = ref.render([f.seed for f in frames], fi, x, y).view(CheckedRGB)
        seeds = sorted({f.seed for f in frames})
        rec = recorder()
        prog = [rec.shoot(s) if rec is not None else None for s in seeds]
        rgb.photons = photon_numbers(prog, [shoot.shoot(s) for s in seeds])
        return rgb

    return render


def compare(prog, ref) -> dict:
    """The check's numbers: the pixels' (perfbench/bench/check.py), then
    the shoot's that the reference's pixels carry (inf where they carry
    none)."""
    from perfbench.bench import check

    numbers = check.compare(prog, ref)
    numbers.update(getattr(ref, "photons", None) or dict.fromkeys(PHOTON_NUMBERS, math.inf))
    return numbers
