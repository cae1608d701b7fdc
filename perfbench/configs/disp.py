"""disp: the CS348B dispersion scene, tests/goldens/disp.pbrt as a scene of
its own.

A crown-glass sphere (Kr 0, Kt 1, index 1.5168, Abbe number 64.17: the
preset of piwell/CS348B-pbrt projectScene/scene.pbrt:40) focuses a
spectral caustic onto a matte disk under one point light; `photonmap`
(12,000 caustic and 4,000 indirect photons, nused 60, maxdist 0.3, no
final gather) is the surface integrator and the renderer's default
`emission` the volume integrator of a thin homogeneous medium; the
lowdiscrepancy sampler and the box filter. The numbers are in disp.json
beside this file, with the cuts from scene.pbrt (`reduced`,
`reduced_from`, `reduced_why`). The scene goes to the renderer through
its scene API (no scene text is parsed), and the same numbers to the
plain reference (perfbench/reference/disp.py, the eye pass, and
disp_shoot.py, the shoot).

What the harness asks of a configuration's module: `emit_scene` (the
scene through the renderer's API), `reference` (the plain reference
that renders pixels of the window's frames for the check) and `compare`
(the check's numbers); perfbench/control_photons.py asks for
`recorder`, `reference_shooter` and `photon_numbers` too.

The eye pass reads each frame's caustic and indirect maps, and the
reference renders them from its own shooter's maps. The check holds
the shoot on its own as well: `emit_scene` wraps the renderer's
`build_photon_maps` in a recorder that keeps, for each frame seed, that
frame's counts and its caustic and indirect maps (device tensors: no
device read in the window). The reference's pixels carry, as the
attribute `photons`, the numbers of the frames' recorded shoots against
the plain shooter's, and `compare` adds them to the pixels' numbers:

- `photon_count_rel_diff`: the largest relative difference of a frame's
  stored caustic, indirect or direct photons;
- `caustic_power_rel_diff`: the largest relative difference of a frame's
  caustic map power (every photon's, every bin's, over the paths shot);
- `caustic_mean_pos_diff`: the largest difference of a coordinate of a
  frame's caustic photons' mean position (world units).

A frame whose shoot was not recorded reads inf on all three.
"""
from __future__ import annotations

import math
import os
import sys

import numpy as np

from perfbench.configs.rainbowc import CheckedRGB, _rotate, _translate

HERE = os.path.dirname(os.path.abspath(__file__))
SHOOTER = "pbrt_tpu_torch.photon.shooter"
KEEP_SHOOTS = 32          # the recorder keeps the last frames' shoots
PHOTON_NUMBERS = ("photon_count_rel_diff", "caustic_power_rel_diff", "caustic_mean_pos_diff")
COUNTED = ("caustic", "indirect", "direct")


def _f32(x):
    """A number as the scene file's parameter lists hold it: float32."""
    return np.asarray(x, np.float32).astype(np.float64)


class ShootRecorder:
    """Stands in for the renderer's `build_photon_maps`: calls it and keeps
    what the frame's shoot stored, by the frame's seed (`frames`)."""

    def __init__(self, build):
        self.build, self.frames = build, {}

    def __call__(self, scene, surf_params, vol_params, options=None):
        ctx = self.build(scene, surf_params, vol_params, options)
        seed = int((options or {}).get("seed", 0))
        stats = ctx.stats
        self.frames.pop(seed, None)
        self.frames[seed] = (dict(stats.get("counts", {})), stats.get("batches", 0),
                             stats.get("shots", 0),
                             *(None if m is None else (m.pos, m.alpha, m.wi)
                               for m in (ctx.caustic, ctx.indirect)))
        while len(self.frames) > KEEP_SHOOTS:
            self.frames.pop(next(iter(self.frames)))
        return ctx

    def shoot(self, seed: int):
        """The recorded shoot of the frame with this seed as a
        disp_shoot.Shoot, None where none was recorded."""
        from perfbench.reference.disp_shoot import Shoot

        if seed not in self.frames:
            return None
        counts, batches, shots, caustic, indirect = self.frames[seed]

        def n(name):
            return int(counts.get(name, [0])[0])

        power, mean = 0.0, np.full(3, np.nan)
        if caustic is not None:
            power = float(caustic[1].double().sum())
            mean = caustic[0].double().mean(0).cpu().numpy()
        return Shoot(batches=int(batches), shots=int(shots), caustic=n("caustic"),
                     indirect=n("indirect"), direct=n("direct"), caustic_power=power,
                     caustic_mean_pos=mean, caustic_map=caustic, indirect_map=indirect)


def _chain():
    """The renderer's `build_photon_maps` and the functions it wraps, the
    outermost first."""
    f = getattr(sys.modules.get(SHOOTER), "build_photon_maps", None)
    while f is not None:
        yield f
        f = getattr(f, "build", None)


def install_recorder():
    """Puts the recorder next to the renderer's `build_photon_maps`, once
    -> the recorder. Another configuration's recorder may wrap the
    function as well (rainbowc.py's, in a process that builds both
    scenes): this one goes innermost and has no `shoots`, the attribute
    by which rainbowc.py finds its own, so either may come first and
    each keeps its own frames."""
    import importlib

    shooter = importlib.import_module(SHOOTER)
    rec = recorder()
    if rec is None:
        chain = list(_chain())
        rec = ShootRecorder(chain[-1])
        if len(chain) > 1:
            chain[-2].build = rec
        else:
            shooter.build_photon_maps = rec
    return rec


def recorder():
    """The recorder `emit_scene` installed, None where there is none."""
    return next((f for f in _chain() if hasattr(f, "frames")), None)


def emit_scene(api, ParamSet, cfg: dict, work: dict):
    """The scene through the renderer's API, up to WorldEnd: film and
    sampler from the workload, the rest from the configuration, in the
    order of tests/goldens/disp.pbrt. Installs the shoot's recorder
    first."""
    install_recorder()

    def params(*items):
        ps = ParamSet(search_dir=HERE)
        for kind, name, values in items:
            ps.add(kind, name, values)
        return ps

    api.pbrt_film("image", params(("integer", "xresolution", [work["xres"]]),
                                  ("integer", "yresolution", [work["yres"]])))
    api.pbrt_sampler(cfg["sampler"], params(("integer", "pixelsamples", [work["spp"]])))
    cam = cfg["camera"]
    api.pbrt_look_at(cam["eye"], cam["look"], cam["up"])
    api.pbrt_camera("perspective", params(("float", "fov", [cam["fov"]])))
    si = cfg["surface_integrator"]
    api.pbrt_surface_integrator(si["name"], params(
        ("integer", "nused", [si["nused"]]), ("bool", "finalgather", [si["finalgather"]]),
        ("float", "maxdist", [si["maxdist"]]),
        ("integer", "indirectphotons", [si["indirectphotons"]]),
        ("integer", "causticphotons", [si["causticphotons"]])))
    api.pbrt_world_begin()
    vol = cfg["volume"]
    api.pbrt_volume(vol["kind"], params(("color", "sigma_a", vol["sigma_a"]),
                                        ("color", "sigma_s", vol["sigma_s"]),
                                        ("point", "p0", vol["p0"]), ("point", "p1", vol["p1"])))
    light = cfg["light"]
    api.pbrt_light_source(light["kind"], params(("point", "from", light["from"]),
                                                ("rgb", "I", light["I"])))
    glass = cfg["glass"]
    api.pbrt_attribute_begin()
    api.pbrt_material("glass", params(("color", "Kr", glass["Kr"]), ("color", "Kt", glass["Kt"]),
                                      ("float", "index", [glass["index"]]),
                                      ("float", "Vn", [glass["Vn"]])))
    api.pbrt_translate(*glass["translate"])
    api.pbrt_shape("sphere", params(("float", "radius", [glass["radius"]])))
    api.pbrt_attribute_end()
    floor = cfg["floor"]
    api.pbrt_attribute_begin()
    api.pbrt_translate(*floor["translate"])
    api.pbrt_rotate(*floor["rotate"])
    api.pbrt_material("matte", params(("rgb", "Kd", floor["Kd"])))
    api.pbrt_shape("disk", params(("float", "radius", [floor["radius"]])))
    api.pbrt_attribute_end()


def reference_scene(cfg: dict):
    """The same scene for the plain reference (perfbench/reference)."""
    from perfbench.reference.disp import DispScene
    from perfbench.reference.pathtrace import look_at

    cam, glass, floor, vol, si = (cfg[k] for k in ("camera", "glass", "floor", "volume",
                                                     "surface_integrator"))
    cam_to_world = np.eye(4)
    cam_to_world[:3, :3] = look_at(cam["eye"], cam["look"], cam["up"])
    cam_to_world[:3, 3] = cam["eye"]
    return DispScene(
        light_pos=_f32(cfg["light"]["from"]), light_rgb=_f32(cfg["light"]["I"]),
        sphere_o2w=_translate(glass["translate"]), sphere_radius=float(_f32(glass["radius"])),
        glass_kr_rgb=_f32(glass["Kr"]), glass_kt_rgb=_f32(glass["Kt"]),
        eta=float(_f32(glass["index"])), vn=float(_f32(glass["Vn"])),
        disk_o2w=_translate(floor["translate"]) @ _rotate(floor["rotate"][0],
                                                           floor["rotate"][1:]),
        disk_radius=float(_f32(floor["radius"])), kd_rgb=_f32(floor["Kd"]),
        box_lo=np.minimum(_f32(vol["p0"]), _f32(vol["p1"])),
        box_hi=np.maximum(_f32(vol["p0"]), _f32(vol["p1"])),
        sigma_a_rgb=_f32(vol["sigma_a"]), sigma_s_rgb=_f32(vol["sigma_s"]),
        cam_to_world=cam_to_world, fov=float(_f32(cam["fov"])), n_used=int(si["nused"]),
        max_dist=float(_f32(si["maxdist"])), caustic_photons=int(si["causticphotons"]),
        indirect_photons=int(si["indirectphotons"]),
        stepsize=float(_f32(cfg["volume_integrator"]["stepsize"])))


def photon_numbers(prog: list, ref: list) -> dict:
    """The shoot's numbers (module docstring) of frames' shoots `prog`
    against `ref` (disp_shoot.Shoot each; None in `prog` where a frame's
    shoot was not recorded)."""
    if not ref or any(p is None for p in prog):
        return dict.fromkeys(PHOTON_NUMBERS, math.inf)
    count = [abs(getattr(p, k) - getattr(r, k)) / max(getattr(r, k), 1)
             for p, r in zip(prog, ref) for k in COUNTED]
    power = [abs(p.caustic_power - r.caustic_power) / max(abs(r.caustic_power), 1e-30)
             for p, r in zip(prog, ref)]
    pos = [np.abs(p.caustic_mean_pos - r.caustic_mean_pos).max() for p, r in zip(prog, ref)]
    return dict(zip(PHOTON_NUMBERS, (float(np.max(v)) for v in (count, power, pos))))


def reference_shooter(cfg: dict, dtype, device):
    """The plain reference shooter of this configuration."""
    from perfbench.reference.disp_shoot import Shooter

    return Shooter(reference_scene(cfg), dtype=dtype, device=device,
                   chunk=16 if str(device).startswith("cuda") else 4)


def reference(cfg: dict, traffic: dict, dtype, device):
    """The plain reference of this configuration at the cell's film:
    `render(frames, fi, x, y)` -> linear RGB [N, 3] of pixels (x, y) of
    frames fi (every frame seen from the scene's own camera, lit by the
    plain shooter's maps of its seed), a CheckedRGB whose `photons` hold
    the frames' recorded shoots against the plain shooter's."""
    import torch
    from perfbench.reference.disp import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(reference_scene(cfg), traffic["xres"], traffic["yres"], traffic["spp"],
                    dtype=dtype, device=device)
    shooter = reference_shooter(cfg, dtype, device)
    shoots = {}

    def shoot(seed):
        if seed not in shoots:
            shoots[seed] = shooter.shoot(seed)
        return shoots[seed]

    def render(frames, fi, x, y):
        lit = [(f.seed, (shoot(f.seed).caustic_map, shoot(f.seed).indirect_map)) for f in frames]
        rgb = ref.render(lit, fi, x, y).view(CheckedRGB)
        seeds = sorted({f.seed for f in frames})
        rec = recorder()
        prog = [rec.shoot(s) if rec is not None else None for s in seeds]
        rgb.photons = photon_numbers(prog, [shoot(s) for s in seeds])
        return rgb

    return render


def compare(prog, ref) -> dict:
    """The check's numbers: the pixels' (perfbench/bench/check.py), over
    every pixel checked, then the shoot's that the reference's pixels
    carry (inf where they carry none)."""
    from perfbench.bench import check

    numbers = check.compare(prog, ref)
    numbers.update(getattr(ref, "photons", None) or dict.fromkeys(PHOTON_NUMBERS, math.inf))
    return numbers
