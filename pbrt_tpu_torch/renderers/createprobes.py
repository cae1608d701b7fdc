"""createprobes renderer: SH radiance probes on a regular grid.

Port of pbrt_tpu/renderers/createprobes.py (reference renderers/
createprobes.cpp:79-352): at the centre of each cell of an nprobes grid
over the scene's bounds, path radiance (maxdepth 2) along the
directions of a sphere quadrature is projected onto SH, in batches of
4096 // D probes (D directions each); the probe file, read by the
useprobes integrator, is an npz with the JAX package's keys (lo, hi,
dims, lmax, coeffs [nz, ny, nx, T, S]), so each package reads the
other's.
"""
from __future__ import annotations

import numpy as np
import torch

from pbrt_tpu_torch.core import sh as shm
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.error import info
from pbrt_tpu_torch.core.geometry import Ray
from pbrt_tpu_torch.integrators.extra import ProbeGrid
from pbrt_tpu_torch.integrators.surface import li_path

PROBE_LANES = 4096   # probes x directions in one li_path batch


def probe_coeffs(scene, centers: np.ndarray, lmax: int, nindir: int, seed: int = 0):
    """SH coefficients [P, T, S] of the radiance arriving at each centre."""
    dev = scene.geom.tri_v0.device
    n_th = max(4, int(np.sqrt(nindir / 2)))
    dirs, w = shm.sphere_quadrature(n_th, 2 * n_th, device=dev)
    D = dirs.shape[0]
    T = shm.sh_terms(lmax)
    Y = shm.sh_evaluate(dirs, lmax)
    P = len(centers)
    coeffs = np.zeros((P, T, spec.N_BINS), np.float32)
    B = max(1, PROBE_LANES // D)
    for i in range(0, P, B):
        origins = torch.as_tensor(centers[i: i + B], device=dev)
        nb = origins.shape[0]
        o = torch.repeat_interleave(origins, D, 0)
        d = dirs.repeat(nb, 1)
        n = o.shape[0]
        zf = torch.zeros((n,), device=dev)
        pixel = torch.arange(n, dtype=torch.int64, device=dev)
        L = li_path(scene, Ray(o, d, zf, torch.full((n,), 1e30, device=dev), zf), pixel,
                    torch.zeros_like(pixel), max_depth=2, seed=seed)
        c = torch.einsum("nt,ns,n->nts", Y.repeat(nb, 1), L, w.repeat(nb))
        coeffs[i: i + nb] = c.reshape(nb, D, T, spec.N_BINS).sum(1).cpu().numpy()
    return coeffs


def render_create_probes(scene, ro, options=None):
    """Renderer entry: write the probe file -> {"probes", "file"}."""
    options = options or {}
    p = ro.renderer_params
    lmax = p.find_one_int("lmax", 4)
    nindir = p.find_one_int("indirectsamples", 512)
    fn = p.find_one_string("filename", "probes.npz")
    nprobes = p.find_int("nprobes")
    dims = (3, 3, 3)
    if nprobes is not None and len(nprobes) == 3:
        dims = tuple(int(x) for x in nprobes)
    p.report_unused('in renderer "createprobes"')
    if options.get("quick"):
        nindir = min(nindir, 64)

    lo = np.asarray(scene.world_lo, np.float64)
    hi = np.asarray(scene.world_hi, np.float64)
    nx, ny, nz = dims
    xs, ys, zs = (lo[a] + (np.arange(k) + 0.5) / k * (hi[a] - lo[a]) for a, k in enumerate(dims))
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    centers = np.stack([gx, gy, gz], -1).reshape(-1, 3).astype(np.float32)
    coeffs = probe_coeffs(scene, centers, lmax, nindir, int(options.get("seed", 0)))
    T = shm.sh_terms(lmax)
    np.savez(fn, lo=lo.astype(np.float32), hi=hi.astype(np.float32),
             dims=np.asarray(dims, np.int32), lmax=lmax,
             coeffs=coeffs.reshape(nx, ny, nz, T, spec.N_BINS).transpose(2, 1, 0, 3, 4))
    info(f"Wrote {len(centers)} SH probes (lmax={lmax}) to {fn}")
    return {"probes": len(centers), "file": fn}


def load_probes(fn: str, device) -> ProbeGrid:
    """Read a probe file (either package's) onto `device`."""
    z = np.load(fn)
    return ProbeGrid(lo=torch.as_tensor(z["lo"], device=device),
                     hi=torch.as_tensor(z["hi"], device=device),
                     dims=tuple(int(x) for x in z["dims"]),
                     coeffs=torch.as_tensor(z["coeffs"], device=device), lmax=int(z["lmax"]))
