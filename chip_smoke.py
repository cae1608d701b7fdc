#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (pbrt_tpu_torch) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from pbrt_tpu_torch/csrc/, holds each kernel
against its plain torch version on the card at the main path's shapes,
renders the 135k-triangle bench scene (wide pipeline, kernel K2) and a
small mixed-material scene (flat t-pass, kernel K1) through the CLI
entry point, checks the images, and prints one JSON line per the
contract below. Every phase raises on failure; the script then exits
non-zero and prints no result. It needs no network and no JAX.

Output, in order: device line (nvidia-smi name and power limit, torch
and CUDA versions), build report, kernel comparisons, renders, then
  {"kernels": [{"name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms"}, ...]}
  <nvidia-smi name, power.limit>
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T_RTOL = 1e-5        # kernel vs plain: t within 1e-5 relative, prim identical
BENCH_RES = 1024
SMALL_RES = 256


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


def compare(name, t, p, t_ref, p_ref):
    """prim identical, t within T_RTOL relative on hits -> max |dt|."""
    import torch

    torch.cuda.synchronize()
    if not torch.equal(p.long(), p_ref.long()):
        bad = int((p.long() != p_ref.long()).sum())
        raise RuntimeError(f"{name}: prim differs on {bad} of {p.numel()} rays")
    hit = p_ref >= 0
    err = (t[hit] - t_ref[hit]).abs()
    max_err = float(err.max()) if err.numel() else 0.0
    if err.numel() and bool((err > T_RTOL * t_ref[hit].abs()).any()):
        raise RuntimeError(f"{name}: t differs beyond {T_RTOL} relative (max {max_err})")
    log(f"  {name}: {int(hit.sum())}/{p.numel()} hits, prim identical, "
        f"max |dt| = {max_err:.3g}")
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
    err = compare("K1 tri_t_pass_kernel vs plain (65536 rays x 4096 tris)", t, p, t_ref, p_ref)
    ms = cuda_ms(lambda: k1.tri_t_pass_cuda(rays8, soa.tris9, soa.n), iters=20)
    plain_ms = cuda_ms(lambda: k1.tri_t_pass_plain(rays8, soa.tris9, soa.n), iters=3)
    log(f"  K1 time: kernel {ms:.4f} ms, plain torch {plain_ms:.4f} ms")
    return err, ms, plain_ms


class SweepRecorder:
    """Stands in for bvh_cuda.wide_sweep during the K2 comparison: every
    wave's pair list goes through the plain version (on a copy of the
    accumulators) and the kernel, which must agree; both are timed."""

    def __init__(self, bvh_cuda):
        self.m = bvh_cuda
        self.ms = self.plain_ms = self.max_err = 0.0
        self.waves = self.pairs = 0

    def __call__(self, pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc):
        import torch

        t_ref, p_ref = t_acc.clone(), p_acc.clone()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        self.m.wide_sweep_plain(pair_block, start, count, rays8, tris16, sentinel, t_ref, p_ref)
        ev[1].record()
        ev[2].record()
        self.m.wide_sweep_cuda(pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc)
        ev[3].record()
        torch.cuda.synchronize()
        self.plain_ms += ev[0].elapsed_time(ev[1])
        self.ms += ev[2].elapsed_time(ev[3])
        self.waves += 1
        self.pairs += int(count.sum())
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


def phase_k2(device):
    """K2 vs its plain version on the same pair lists (every wave), at
    the bench geometry, for camera, shadow (any-hit) and incoherent
    rays; then wide_t_pass vs plain brute force on an 8192-ray subset."""
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
    real_sweep = bvh_cuda.wide_sweep
    try:
        rec = SweepRecorder(bvh_cuda)
        bvh_cuda.wide_sweep = rec
        t_cam, p_cam = bvh_cuda.wide_t_pass(wb, cam_o, cam_d, zeros, inf, coherent=True)
        results["camera"] = rec
        # shadow rays from the primary hits toward a light (bench.py)
        hit_p = cam_o + torch.where(p_cam >= 0, t_cam, 0.0)[:, None] * cam_d
        sd = torch.tensor([0.0, 6.0, 0.0], device=device)[None, :] - hit_p
        sdist = torch.sqrt(torch.sum(sd * sd, -1))
        sdir = sd / torch.clamp(sdist, min=1e-9)[:, None]
        s_o = hit_p + sdir * 1e-3
        s_tmax = torch.where(p_cam >= 0, sdist * 0.999, -1.0)
        rec = SweepRecorder(bvh_cuda)
        bvh_cuda.wide_sweep = rec
        bvh_cuda.wide_t_pass(wb, s_o, sdir, zeros, s_tmax, any_hit=True, coherent=True)
        results["shadow"] = rec
        rng = np.random.RandomState(0)
        i_o = torch.as_tensor(rng.rand(n, 3).astype(np.float32) * 6 - 3, device=device)
        i_d = rng.randn(n, 3).astype(np.float32)
        i_d = torch.as_tensor(i_d / np.linalg.norm(i_d, axis=-1, keepdims=True), device=device)
        rec = SweepRecorder(bvh_cuda)
        bvh_cuda.wide_sweep = rec
        bvh_cuda.wide_t_pass(wb, i_o, i_d, zeros, inf)
        results["incoherent"] = rec
    finally:
        bvh_cuda.wide_sweep = real_sweep
    for name, r in results.items():
        log(f"  K2 {name} rays ({n}): {r.waves} waves, {r.pairs} (tile, block) pairs, "
            f"kernel {r.ms:.3f} ms, plain torch {r.plain_ms:.3f} ms, prim identical, "
            f"max |dt| = {r.max_err:.3g}")

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
    cam = results["camera"]
    max_err = max(r.max_err for r in results.values())
    return max_err, cam.ms, cam.plain_ms


def render(scene_text, out_name, tmp, extra=()):
    """Write the scene and render it through the CLI entry point."""
    from pbrt_tpu_torch import main as cli
    from pbrt_tpu_torch.io.image import read_image

    path = os.path.join(tmp, out_name + ".pbrt")
    with open(path, "w") as f:
        f.write(scene_text)
    out = os.path.join(tmp, out_name + ".pfm")
    t0 = time.perf_counter()
    rc = cli.main(["--quiet", "--outfile", out, *extra, path])
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"render of {out_name} failed (rc {rc})")
    img = read_image(out)
    if not np.all(np.isfinite(img)) or not img.mean() > 0:
        raise RuntimeError(f"{out_name}: image not finite or black (mean {img.mean()})")
    return img, seconds


def main():
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    log(f"[1] device: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from pbrt_tpu_torch.ops import build

    build.load_kernels()
    log(f"[2] kernels: {'cached' if build.BuildInfo.cached else 'built'} "
        f"{build.BuildInfo.path} from pbrt_tpu_torch/csrc/*.cu for sm_90a in "
        f"{build.BuildInfo.seconds:.1f} s")
    for line in build.BuildInfo.ptxas.splitlines():
        if "ptxas" in line and ("Used" in line or "Compiling" in line or "spill" in line):
            log("  " + line.strip())

    log("[3] K1 (flat t-pass) vs plain torch")
    k1_err, k1_ms, k1_plain_ms = phase_k1(device)
    log("[4] K2 (wide-leaf sweep) vs plain torch at the bench geometry")
    k2_err, k2_ms, k2_plain_ms = phase_k2(device)

    from pbrt_tpu_torch.ops import bvh_cuda, intersect_cuda

    with tempfile.TemporaryDirectory() as tmp:
        # the main path: counts reset here, read after both renders
        intersect_cuda.launches = 0
        bvh_cuda.launches = 0
        log(f"[5] bench render {BENCH_RES}x{BENCH_RES}, 1 spp, maxdepth 5")
        img, sec = render(bench_scene_text(BENCH_RES), "bench", tmp)
        k2_render = bvh_cuda.launches
        log(f"  {sec:.2f} s end to end (parse + compile + BVH build + render), "
            f"{BENCH_RES * BENCH_RES / sec:.0f} camera rays/s, image mean {img.mean():.5f}, "
            f"K2 launches {k2_render}")
        if k2_render <= 0:
            raise RuntimeError("bench render did not launch K2")
        log(f"[6] small render {SMALL_RES}x{SMALL_RES}, 4 spp (matte, plastic, mirror, "
            "glass Vn, triangle area light)")
        img, sec = render(small_scene_text(SMALL_RES, 4), "small", tmp)
        launches = {"k1": intersect_cuda.launches, "k2": bvh_cuda.launches}
        log(f"  {sec:.2f} s end to end, image mean {img.mean():.5f}, "
            f"K1 launches {launches['k1']}")
        if launches["k1"] <= 0:
            raise RuntimeError("small render did not launch K1")

        # the card path against the CPU path (plain twins) on a small input
        log("[7] small render 32x32 on the card vs on the CPU")
        text = small_scene_text(32, 4)
        gpu, _ = render(text, "check_gpu", tmp, extra=("--tile-samples", "4096"))
        cpu, _ = render(text, "check_cpu", tmp,
                        extra=("--tile-samples", "4096", "--device", "cpu"))
        rel = (np.abs(gpu - cpu) / np.maximum(np.abs(cpu), 1e-6)).max(-1)
        mean_rel = abs(gpu.mean() - cpu.mean()) / cpu.mean()
        log(f"  mean rel diff {mean_rel:.3g}, pixels within 1e-3: {(rel <= 1e-3).mean():.4f}")
        if mean_rel > 5e-3 or (rel <= 1e-3).mean() < 0.99:
            raise RuntimeError("card render disagrees with the CPU render")

    kernels = [
        {"name": "tri_t_pass_kernel", "route": "cuda",
         "source": "pbrt_tpu_torch/csrc/intersect.cu",
         "replaces": "pbrt_tpu/ops/intersect_pallas.py:35",
         "launches": launches["k1"], "max_abs_err": k1_err, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "wide_sweep_kernel", "route": "cuda",
         "source": "pbrt_tpu_torch/csrc/bvh_sweep.cu",
         "replaces": "pbrt_tpu/ops/bvh_pallas.py:54",
         "launches": launches["k2"], "max_abs_err": k2_err, "ms": k2_ms,
         "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
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
