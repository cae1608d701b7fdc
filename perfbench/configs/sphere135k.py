"""sphere135k: the repo's mesh bench geometry as a scene of its own.

A 260 x 260 UV sphere of radius 1 at (0, 0.4, 0) (135,200 triangles)
over a two-triangle 24 x 24 floor, both matte, lit by one point light,
rendered by the path integrator at depth 5 with the lowdiscrepancy
sampler. The sizes are in sphere135k.json beside this file. The
triangles are made here in NumPy and handed to the renderer through its
scene API (no scene text is parsed) and to the plain reference alike.

What the harness asks of a configuration's module: `emit_scene` (the
scene through the renderer's API) and `reference` (the plain reference
that renders pixels of the window's frames for the check).
"""
from __future__ import annotations

import numpy as np


def uv_sphere(n_theta: int, n_phi: int, radius: float, center):
    """-> (P [V, 3] float32, indices [T * 3] int32), 2 * n_theta * n_phi
    triangles in the layout of scripts/bench_scene.py's uv_sphere."""
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
    return P.astype(np.float32), np.stack([a, c, b, b, c, d], -1).reshape(-1).astype(np.int32)


def meshes(cfg: dict):
    """-> [(P, indices, kd rgb)] of the sphere and the floor."""
    s, f = cfg["sphere"], cfg["floor"]
    P, idx = uv_sphere(s["n_theta"], s["n_phi"], s["radius"], s["center"])
    return [(P, idx, s["kd"]),
            (np.asarray(f["corners"], np.float32), np.asarray(f["indices"], np.int32), f["kd"])]


def emit_scene(api, ParamSet, cfg: dict, work: dict):
    """The scene through the renderer's API, up to WorldEnd: film and
    sampler from the workload, the rest from the configuration."""
    def params(*items):
        ps = ParamSet()
        for kind, name, values in items:
            ps.add(kind, name, values)
        return ps

    api.pbrt_film("image", params(("integer", "xresolution", [work["xres"]]),
                                  ("integer", "yresolution", [work["yres"]])))
    api.pbrt_sampler(cfg["sampler"], params(("integer", "pixelsamples", [work["spp"]])))
    cam = cfg["camera"]
    api.pbrt_look_at(cam["eye"], cam["look"], cam["up"])
    api.pbrt_camera("perspective", params(("float", "fov", [cam["fov"]])))
    integ = cfg["integrator"]
    api.pbrt_surface_integrator(integ["name"],
                                params(("integer", "maxdepth", [integ["maxdepth"]])))
    api.pbrt_world_begin()
    light = cfg["light"]
    api.pbrt_light_source("point", params(("point", "from", light["from"]),
                                          ("rgb", "I", light["I"])))
    for P, idx, kd in meshes(cfg):
        api.pbrt_material("matte", params(("rgb", "Kd", kd)))
        api.pbrt_shape("trianglemesh", params(("integer", "indices", idx),
                                              ("point", "P", P.reshape(-1))))


def reference_scene(cfg: dict):
    """The same scene for the plain reference (perfbench/reference)."""
    from perfbench.reference.pathtrace import MatteMeshScene

    tris, mats, kds = [], [], []
    for m, (P, idx, kd) in enumerate(meshes(cfg)):
        tris.append(P[idx.reshape(-1, 3)])
        mats.append(np.full(len(idx) // 3, m))
        kds.append(kd)
    return MatteMeshScene(tris=np.concatenate(tris), tri_mat=np.concatenate(mats),
                          kd_rgb=np.asarray(kds, np.float64),
                          light_from=np.asarray(cfg["light"]["from"], np.float64),
                          light_rgb=np.asarray(cfg["light"]["I"], np.float64),
                          fov=float(cfg["camera"]["fov"]),
                          maxdepth=int(cfg["integrator"]["maxdepth"]))


def reference(cfg: dict, traffic: dict, dtype, device):
    """The plain reference of this configuration at the cell's film:
    `render(frames, fi, x, y)` -> linear RGB [N, 3] of pixels (x, y) of
    frames fi, a frame without a pose seen from the scene's own camera."""
    from perfbench.reference.pathtrace import Reference

    ref = Reference(reference_scene(cfg), traffic["xres"], traffic["yres"], traffic["spp"],
                    dtype=dtype, device=device)
    cam = cfg["camera"]

    def render(frames, fi, x, y):
        poses = [(f.seed, f.eye, f.look, f.up) if f.eye is not None
                 else (f.seed, cam["eye"], cam["look"], cam["up"]) for f in frames]
        return ref.render(poses, fi, x, y)

    return render
