"""bsdftest: Monte Carlo white-furnace estimates for the BSDF set.

Port of pbrt_tpu/tools/bsdftest.py (reference tools/bsdftest.cpp:52-110):
estimate the reflectance of a matrix of BSDFs under a uniform unit
environment with three sampling strategies (BSDF importance sampling,
uniform and cosine hemisphere sampling); under white-furnace conditions
each estimate must stay below 1 (with 5% slack) and the strategies must
agree for sampleable lobes. Exit code 0: no violation, no mismatch.

    python -m pbrt_tpu_torch.tools bsdftest [N] [--device cuda|cpu]

N samples per estimate (16,384 by default) on the given device (the
card by default; it fails when there is none).
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

WO_ANGLES = (10.0, 45.0, 80.0)
CASES = (("matte", 0.0), ("plastic", 0.1), ("plastic", 0.01), ("substrate", 0.1),
         ("mirror", 0.0), ("glass", 0.0))
SPECULAR_ONLY = ("mirror", "glass")


def bsdf_estimates(n: int, device) -> list:
    """[(kind, roughness, wo angle in degrees, rho by BSDF sampling, rho
    by uniform hemisphere sampling, rho by cosine hemisphere sampling)];
    the last two are None for the delta BSDFs."""
    from pbrt_tpu_torch.core import spectrum as spec
    from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere
    from pbrt_tpu_torch.materials.bsdf import (
        BsdfParams,
        Frame,
        bsdf_f,
        bsdf_sample,
        material_lobes,
    )
    from pbrt_tpu_torch.materials.registry import KIND_ID
    from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu

    S = spec.N_BINS
    lane = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros((n,), dtype=torch.int64, device=device)

    def axis(v):
        return torch.tensor(v, dtype=torch.float32, device=device).expand(n, 3)

    frame = Frame(ss=axis([1.0, 0, 0]), ts=axis([0, 1.0, 0]), ns=axis([0, 0, 1.0]),
                  ng=axis([0, 0, 1.0]))

    def make_params(kind, rough, kd=0.5, ks=0.5):
        full = lambda v: torch.full((n, S), v, device=device)
        return BsdfParams.none(n, device)._replace(
            kind=torch.full((n,), KIND_ID[kind], dtype=torch.int64, device=device),
            kd=full(kd), ks=full(ks), kr=full(ks), kt=full(ks),
            rough_u=torch.full((n,), rough, device=device),
            rough_v=torch.full((n,), rough, device=device),
            eta=torch.full((n,), 1.5, device=device))

    def rho(est):
        return float(spec.y(torch.mean(est, 0)))

    def est_bsdf(lobes, wo):
        """BSDF importance sampling (the only strategy that can hit
        delta lobes)."""
        bs = bsdf_sample(lobes, frame, wo, iu(lane, zero, 0, 0), iu(lane, zero, 0, 1),
                         iu(lane, zero, 0, 2), iu(lane, zero, 0, 3))
        cos_i = torch.abs(bs.wi[..., 2])
        est = torch.where(((bs.pdf > 1e-9) & bs.valid)[:, None],
                          bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-9))[:, None],
                          torch.zeros((), device=device))
        return rho(est)

    def est_uniform(lobes, wo):
        """Uniform hemisphere sampling, pdf = 1 / 2pi."""
        cz = iu(lane, zero, 1, 0)
        ph = 2.0 * math.pi * iu(lane, zero, 1, 1)
        sz = torch.sqrt(torch.clamp(1.0 - cz * cz, min=0.0))
        wi = torch.stack([sz * torch.cos(ph), sz * torch.sin(ph), cz], -1)
        return rho(bsdf_f(lobes, frame, wo, wi) * (cz * 2.0 * math.pi)[:, None])

    def est_cosine(lobes, wo):
        """Cosine hemisphere sampling, pdf = cos / pi."""
        wi = cosine_sample_hemisphere(iu(lane, zero, 2, 0), iu(lane, zero, 2, 1))
        return rho(bsdf_f(lobes, frame, wo, wi) * math.pi)

    rows = []
    for kind, rough in CASES:
        lobes = material_lobes(make_params(kind, rough))
        for ang in WO_ANGLES:
            th = np.deg2rad(ang)
            wo = torch.tensor([np.sin(th), 0.0, np.cos(th)], dtype=torch.float32,
                              device=device).expand(n, 3)
            r_b = est_bsdf(lobes, wo)
            if kind in SPECULAR_ONLY:
                rows.append((kind, rough, ang, r_b, None, None))
            else:
                rows.append((kind, rough, ang, r_b, est_uniform(lobes, wo),
                             est_cosine(lobes, wo)))
    return rows


def bsdftest(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    n = int(argv[0]) if argv else 1 << 14
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("bsdftest: no CUDA device available; pass --device cpu", file=sys.stderr)
        return 1
    ok = True
    print(f"{'bsdf':10s} {'rough':>6s} {'wo':>5s}  "
          f"{'rho[bsdf]':>9s} {'rho[unif]':>9s} {'rho[cos]':>9s}")
    for kind, rough, ang, r_b, r_u, r_c in bsdf_estimates(n, torch.device(device)):
        if r_u is None:
            print(f"{kind:10s} {rough:>6g} {ang:4.0f}d  {r_b:9.4f} "
                  f"{'(delta)':>9s} {'(delta)':>9s}"
                  + ("  [ENERGY VIOLATION]" if r_b >= 1.05 else ""))
            ok = ok and r_b < 1.05
            continue
        # 8%: the cosine estimator of microfacet terms is noisy at
        # grazing wo (1/max(cos) spikes when wh nears the horizon)
        agree = (abs(r_u - r_b) < 0.08 * max(r_b, 0.05)
                 and abs(r_c - r_b) < 0.08 * max(r_b, 0.05))
        tag = ("ENERGY VIOLATION" if r_b >= 1.05
               else ("STRATEGY MISMATCH" if not agree else "ok"))
        if r_b >= 1.05 or not agree:
            ok = False
        print(f"{kind:10s} {rough:>6g} {ang:4.0f}d  {r_b:9.4f} "
              f"{r_u:9.4f} {r_c:9.4f}  [{tag}]")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(bsdftest())
