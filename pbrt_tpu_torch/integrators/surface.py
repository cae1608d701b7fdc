"""Wavefront surface integrators.

Port of the "path", "directlighting", "whitted" and "ambientocclusion"
integrators of pbrt_tpu/integrators/surface.py (reference integrators/
path.cpp:52-123, directlighting.cpp, whitted.cpp:40,
ambientocclusion.cpp): fixed-depth loops over ray batches with alive
masks. In `path`, per vertex one light is sampled by the power CDF
(estimate_direct) and the BSDF continuation sample is reused as the
second MIS strategy: emission found at the next vertex (an area light,
or an environment map for rays that escape) is weighted by
power_heuristic(bsdf_pdf, light_pdf). directlighting and whitted add
the environment of escaped rays unweighted; ambientocclusion ignores it.

transmittance_fn(p, wi, dist) -> [N, S], when given, attenuates each
light sample by the participating medium (renderers/driver.py).

Spectral dispersion: lanes carry lam_nm (< 0 means dense spectrum). The
first dispersive specular transmission importance-samples ONE
wavelength bin from the throughput (spectrum.sample_bin); it is
committed only when the sampled lobe really transmits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core import graphs as cuda_graphs
from pbrt_tpu_torch.core.geometry import Ray, coordinate_system, cross, dot, normalize
from pbrt_tpu_torch.core.sampling import cosine_sample_hemisphere, power_heuristic
from pbrt_tpu_torch.accel.intersect import Hit
from pbrt_tpu_torch.lights.lighting import (
    LightSample,
    area_emission,
    area_tri_pdf,
    env_le,
    light_pdf,
    sample_light,
)
from pbrt_tpu_torch.materials.bsdf import (
    Frame,
    Lobes,
    bsdf_f,
    bsdf_pdf,
    bsdf_sample,
    has_non_specular,
    material_lobes,
)
from pbrt_tpu_torch.samplers.samplers import integrator_base, integrator_uniform_at
from pbrt_tpu_torch.samplers.samplers import integrator_uniform as iu

S = spec.N_BINS
BIG = 1e30
RAY_EPS = 1e-3


def shading_frame(scene, hit: Hit) -> Frame:
    """make_frame + bump mapping when the scene uses bump textures."""
    from pbrt_tpu_torch.scene.compile import eval_bump

    return eval_bump(scene, hit, make_frame(hit))


def make_frame(hit: Hit) -> Frame:
    ss = normalize(hit.dpdu)
    # re-orthogonalize against ns
    ss = normalize(ss - hit.ns * dot(ss, hit.ns)[..., None])
    degen = torch.sum(ss * ss, -1) < 0.5
    fb1, _ = coordinate_system(hit.ns)
    ss = torch.where(degen[..., None], fb1, ss)
    ts = cross(hit.ns, ss)
    return Frame(ss=ss, ts=ts, ns=hit.ns, ng=hit.ng)


def shadow_ray(p, wi, dist, valid, time=None) -> Ray:
    """The shadow ray toward a light sample: it leaves p along wi and
    stops short of the light; lanes not `valid` get an empty interval."""
    R = p.shape[0]
    dev = p.device
    big = torch.full((), BIG, device=dev)
    tmax = torch.where(dist >= BIG, big, dist * (1.0 - 1e-3))
    return Ray(
        o=p + wi * RAY_EPS,
        d=wi,
        tmin=torch.zeros((R,), device=dev),
        tmax=torch.where(valid, tmax, torch.full((), -1.0, device=dev)),
        time=torch.zeros((R,), device=dev) if time is None else time,
    )


def _occluded(scene, p, wi, dist, valid, time=None):
    """Shadow-ray query toward a light sample."""
    # shadow beams (clustered origins, light-convergent directions)
    # traverse with the frustum cull
    return scene.intersect_p(shadow_ray(p, wi, dist, valid, time), coherent=True)


class DirectSample(NamedTuple):
    """estimate_direct up to its shadow ray: the light sample, its pick
    pmf, the BSDF value and cosine toward it, and the lanes that need
    the shadow ray (`usable`)."""
    ray: Ray
    ls: LightSample
    pick_pmf: torch.Tensor
    f: torch.Tensor
    cos_i: torch.Tensor
    usable: torch.Tensor


def sample_direct(scene, lobes: Lobes, frame: Frame, p, wo, u_light, u1, u2, active,
                  time=None):
    """estimate_direct's half before the shadow traversal -> DirectSample,
    or None in a scene without lights."""
    if scene.lights is None:
        return None
    light_idx, pick_pmf = scene.light_dist.sample_discrete(u_light)
    ls = sample_light(scene.lights, light_idx, p, u1, u2)
    f = bsdf_f(lobes, frame, wo, ls.wi)
    cos_i = torch.abs(dot(ls.wi, frame.ns))
    usable = (active & (cos_i > 0) & (ls.pdf > 1e-9) & ~spec.is_black(ls.L)
              & ~spec.is_black(f))
    return DirectSample(shadow_ray(p, ls.wi, ls.dist, usable, time), ls, pick_pmf, f, cos_i,
                        usable)


def finish_direct(scene, lobes: Lobes, frame: Frame, p, wo, ds, occluded,
                  transmittance_fn=None, mis: bool = True):
    """estimate_direct's half after the shadow traversal: the sample's
    contribution [N, S] where its shadow ray was not `occluded`."""
    if ds is None:
        return torch.zeros(p.shape[:-1] + (S,), device=p.device)
    ls, pick_pmf, cos_i = ds.ls, ds.pick_pmf, ds.cos_i
    usable = ds.usable & ~occluded
    # MIS weight (light strategy): delta lights get weight 1
    if mis:
        bpdf = bsdf_pdf(lobes, frame, wo, ls.wi)
        w = torch.where(ls.is_delta, torch.ones((), device=p.device),
                        power_heuristic(1.0, ls.pdf * pick_pmf, 1.0, bpdf))
    else:
        w = torch.ones_like(cos_i)
    contrib = ds.f * ls.L * (cos_i * w / torch.clamp(ls.pdf * pick_pmf, min=1e-12))[..., None]
    if transmittance_fn is not None:
        contrib = contrib * transmittance_fn(p, ls.wi, ls.dist)
    return torch.where(usable[..., None], contrib, torch.zeros((), device=p.device))


@probes.spanned("path/direct")
def estimate_direct(scene, lobes: Lobes, frame: Frame, p, wo, u_light, u1, u2,
                    active, transmittance_fn=None, time=None, mis: bool = True):
    """One-light direct illumination, light-sampling half of the MIS
    pair (the BSDF half is the next vertex's emission). Returns [N, S].
    Callers that add no BSDF half (the bidirectional MLT paths,
    integrators/bidir.py) pass mis=False: the light-sampling estimator
    alone, unweighted. sample_direct, the shadow traversal and
    finish_direct in turn."""
    ds = sample_direct(scene, lobes, frame, p, wo, u_light, u1, u2, active, time=time)
    occluded = None if ds is None else scene.intersect_p(ds.ray, coherent=True)
    return finish_direct(scene, lobes, frame, p, wo, ds, occluded, transmittance_fn, mis)


class PathState(NamedTuple):
    ray_o: torch.Tensor
    ray_d: torch.Tensor
    throughput: torch.Tensor     # [N, S]
    L: torch.Tensor              # [N, S]
    alive: torch.Tensor          # [N]
    prev_bsdf_pdf: torch.Tensor  # [N] pdf of the sample that produced this ray
    prev_specular: torch.Tensor  # [N] previous bounce was specular
    lam_nm: torch.Tensor         # [N] carried wavelength (<0: dense)


def _add_hit_emission(scene, st: PathState, hit: Hit, first: bool):
    """Emission picked up by the continuation/camera ray, MIS-weighted."""
    if scene.lights is None:
        return st.L
    dev = hit.t.device
    wo = -normalize(st.ray_d)
    light = torch.clamp(hit.light, min=0)
    le = area_emission(scene.lights, light, hit.ng, wo)
    emissive = hit.valid & (hit.light >= 0)
    if first:
        w = torch.ones(hit.t.shape, device=dev)
    else:
        # light pdf of having sampled this direction toward the area light
        d = hit.p - st.ray_o
        dist2 = torch.clamp(torch.sum(d * d, -1), min=1e-12)
        cos_l = dot(hit.ng, wo)
        lpdf = area_tri_pdf(scene.lights, light, dist2, cos_l)
        pick = scene.light_dist.pdf_discrete(light)
        w = torch.where(st.prev_specular, torch.ones((), device=dev),
                        power_heuristic(1.0, st.prev_bsdf_pdf, 1.0, lpdf * pick))
    add = st.throughput * le * w[..., None]
    return st.L + torch.where((emissive & st.alive)[..., None], add,
                              torch.zeros((), device=dev))


def _add_escape_emission(scene, st: PathState, escaped, first: bool):
    """Environment-map radiance for rays that left the scene; after the
    first bounce MIS-weighted against the env lights' sampling pdf
    unless the previous bounce was specular."""
    if scene.lights is None or not scene.lights.envs:
        return st.L
    dev = st.L.device
    le = env_le(scene.lights, st.ray_d)
    if first:
        w = torch.ones(escaped.shape, device=dev)
    else:
        lp = torch.zeros(escaped.shape, device=dev)
        for env in scene.lights.envs:
            li = torch.full(escaped.shape, env.light_idx, dtype=torch.int64, device=dev)
            lp_e = light_pdf(scene.lights, li, st.ray_o, normalize(st.ray_d))
            lp = lp + lp_e * scene.light_dist.pdf_discrete(li)
        w = torch.where(st.prev_specular, torch.ones((), device=dev),
                        power_heuristic(1.0, st.prev_bsdf_pdf, 1.0, lp))
    add = st.throughput * le * w[..., None]
    return st.L + torch.where((escaped & st.alive)[..., None], add, torch.zeros((), device=dev))


def li_path(scene, ray: Ray, pixel, sidx, max_depth: int = 5, seed: int = 0,
            rr_start: int = 3, transmittance_fn=None):
    """Path-traced radiance for a ray batch (reference integrators/
    path.cpp:52-123: MIS one-light, RR after bounce 3). Returns [N, S].

    Where core/graphs.py's rule allows and without a medium (a
    transmittance traverses), the shading between the traversals replays
    as CUDA graphs (PathGraphs); elsewhere it runs eagerly. Both run the
    same stretches on the same values."""
    graphs = cuda_graphs.EAGER if transmittance_fn is not None else cuda_graphs.graphs_for(
        scene, PathGraphs, ray.o, (ray.o.shape[0], max_depth, rr_start))
    ray = graphs.put("ray", ray)
    base = graphs.put("base", integrator_base(pixel, sidx, seed))

    def u_fn(depth, dim):
        return integrator_uniform_at(base, depth, dim)

    return graphs.result(_li_path_impl(scene, ray, u_fn, max_depth, rr_start,
                                       transmittance_fn, graphs))


def li_path_psamples(scene, ray: Ray, u, max_depth: int = 5, transmittance_fn=None):
    """Path radiance driven by an explicit primary-sample vector u [N, D]
    (Kelemen MLT, reference renderers/metropolis.cpp MLTSample: the
    psample stream is the path): 10 dims a bounce, the last dim reused
    past the end; Russian roulette off, so the path is a deterministic
    function of u."""
    DPB = 10

    def u_fn(depth, dim):
        return u[:, min(depth * DPB + (dim % DPB), u.shape[1] - 1)]

    return _li_path_impl(scene, ray, u_fn, max_depth, max_depth + 1, transmittance_fn)


class _Shading(NamedTuple):
    """What stretch A hands to the shadow traversal and to stretch B."""
    alive: torch.Tensor
    lobes: Lobes
    frame: Frame
    wo: torch.Tensor
    direct: DirectSample     # None in a scene without lights


def _path_start(ray: Ray):
    """-> (the camera rays' PathState, the traversals' tmin, the first
    traversal's tmax)."""
    N = ray.o.shape[0]
    dev = ray.o.device
    st = PathState(
        ray_o=ray.o, ray_d=ray.d,
        throughput=torch.ones((N, S), device=dev),
        L=torch.zeros((N, S), device=dev),
        alive=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_bsdf_pdf=torch.zeros((N,), device=dev),
        prev_specular=torch.zeros((N,), dtype=torch.bool, device=dev),
        lam_nm=torch.full((N,), -1.0, device=dev),
    )
    return st, torch.zeros((N,), device=dev), _next_tmax(st.alive)


def _next_tmax(alive):
    # dead lanes get an empty [0, -1] interval: the accelerators skip
    # them (the flat t-pass lists only live rays on the device; the
    # packet pipeline sorts them into all-dead tiles)
    dev = alive.device
    return torch.where(alive, torch.full((), BIG, device=dev), torch.full((), -1.0, device=dev))


def _stretch_a(scene, st: PathState, hit: Hit, u_fn, depth: int, shade: bool, tm):
    """Stretch A, from the bounce's hit to its shadow ray: the emission
    the ray found and, when `shade`, the material, the shading frame and
    the light sample -> (PathState, _Shading or None)."""
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    st = st._replace(L=_add_hit_emission(scene, st, hit, depth == 0))
    st = st._replace(L=_add_escape_emission(scene, st, st.alive & ~hit.valid, depth == 0))
    if not shade:
        return st, None
    alive = st.alive & hit.valid
    lobes = material_lobes(eval_bsdf_params(scene, hit))
    frame = shading_frame(scene, hit)
    wo = -normalize(st.ray_d)
    # direct lighting at non-specular vertices
    direct = sample_direct(scene, lobes, frame, hit.p, wo, u_fn(depth, 0), u_fn(depth, 1),
                           u_fn(depth, 2), alive & has_non_specular(lobes), time=tm)
    return st, _Shading(alive, lobes, frame, wo, direct)


def _stretch_b(scene, st: PathState, hit: Hit, sh: _Shading, occluded, u_fn, depth: int,
               rr_start: int, transmittance_fn):
    """Stretch B, from the shadow traversal to the next one: the light
    sample's contribution, the BSDF continuation, Russian roulette ->
    (the next PathState, the next traversal's tmax)."""
    dev = hit.p.device
    zero = torch.zeros((), device=dev)
    alive, lobes, frame, wo = sh.alive, sh.lobes, sh.frame, sh.wo
    Ld = finish_direct(scene, lobes, frame, hit.p, wo, sh.direct, occluded, transmittance_fn)
    # carried-wavelength band filter on new light (monochromatic lanes)
    mono = st.lam_nm > 0.0
    Ld = torch.where(mono[..., None], spec.band_filter(Ld, st.lam_nm), Ld)
    st = st._replace(L=st.L + st.throughput * Ld * alive[..., None])

    # continuation: BSDF sample (with dispersion wavelength pick); the
    # per-material dispersive flag has a trailing 0 (hit.mat = -1 clips
    # to 0 as in the reference)
    disp = torch.cat([scene.material_dispersive.to(torch.int32),
                      torch.zeros((1,), dtype=torch.int32, device=dev)])
    is_disp = disp[torch.clamp(hit.mat, 0, disp.shape[0] - 1)] > 0
    # the candidate wavelength is committed only when the sampled
    # lobe is specular transmission (reflection does not disperse)
    need_lambda = is_disp & (st.lam_nm < 0.0) & alive
    bin_idx, bin_w = spec.sample_bin(st.throughput, u_fn(depth, 3))
    new_lam = spec.bin_wavelength(bin_idx)
    oh = spec.one_hot(bin_idx)
    lam_cand = torch.where(need_lambda, new_lam, st.lam_nm)

    bs = bsdf_sample(lobes, frame, wo, u_fn(depth, 4), u_fn(depth, 5),
                     u_fn(depth, 6), u_fn(depth, 7), lam_nm=lam_cand,
                     u_pick=u_fn(depth, 9))
    commit_lambda = need_lambda & bs.did_transmit
    tp = torch.where(commit_lambda[..., None], st.throughput * oh * bin_w[..., None],
                     st.throughput)
    lam = torch.where(commit_lambda, new_lam, st.lam_nm)
    cos_i = torch.abs(dot(bs.wi, frame.ns))
    tp_new = tp * bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[..., None]
    alive = alive & bs.valid & ~spec.is_black(tp_new)

    # Russian roulette (reference path.cpp: after bounce 3)
    if depth >= rr_start:
        q = torch.clamp(spec.y(tp_new) / torch.clamp(spec.y(tp), min=1e-9), 0.05, 1.0)
        survive = u_fn(depth, 8) < q
        tp_new = tp_new / torch.clamp(q, min=1e-9)[..., None]
        alive = alive & survive

    st = PathState(
        ray_o=hit.p + bs.wi * RAY_EPS,
        ray_d=bs.wi,
        throughput=torch.where(alive[..., None], tp_new, zero),
        L=st.L,
        alive=alive,
        prev_bsdf_pdf=bs.pdf,
        prev_specular=bs.is_specular,
        lam_nm=lam,
    )
    return st, _next_tmax(alive)


def _li_path_impl(scene, ray: Ray, u_fn, max_depth: int, rr_start: int, transmittance_fn,
                  graphs=cuda_graphs.EAGER):
    """The path loop: each depth traverses, runs stretch A, traces the
    shadow rays and runs stretch B, the stretches through `graphs`
    (core/graphs.py EAGER, or PathGraphs, whose static buffers then hold
    the ray, the hits and the shadow rays' answers)."""
    st, tmin, tmax = graphs.keep("start", lambda: _path_start(ray))
    tm = ray.time  # shutter time, constant along the path
    for depth in range(max_depth + 1):
        with probes.scope("path/bounce"):
            hit = graphs.put("hit", scene.intersect(Ray(st.ray_o, st.ray_d, tmin, tmax, tm),
                                                    coherent=depth == 0))
            shade = depth < max_depth
            st, sh = graphs.run(("a", depth),
                                lambda: _stretch_a(scene, st, hit, u_fn, depth, shade, tm))
            if not shade:
                break
            occluded = None
            if sh.direct is not None:
                with probes.scope("path/direct"):
                    occluded = scene.intersect_p(sh.direct.ray, coherent=True)
                occluded = graphs.put("occluded", occluded)
            st, tmax = graphs.run(("b", depth), lambda: _stretch_b(
                scene, st, hit, sh, occluded, u_fn, depth, rr_start, transmittance_fn))
    return st.L


class PathGraphs(cuda_graphs.StretchGraphs):
    """The path loop's stretches of one compiled scene, lane count N,
    max_depth and rr_start, as CUDA graphs (core/graphs.py): per depth
    stretch A and stretch B, and stretch A alone at max_depth (2
    max_depth + 1 graphs), sharing one memory pool. Each tile refills
    the static buffers with the camera rays, the per-lane hash
    integrator_base, each bounce's hit and each shadow traversal's
    answer; `start` keeps the constants of _path_start."""

    name = "path"
    start = None


def li_direct(scene, ray: Ray, pixel, sidx, max_depth: int = 5, seed: int = 0,
              strategy: str = "all", transmittance_fn=None):
    """Direct lighting integrator (reference integrators/directlighting
    .cpp; strategy "all" sums every light, "one" samples one). Specular
    reflection/transmission is followed up to max_depth."""
    return _li_direct_or_whitted(scene, ray, pixel, sidx, max_depth, seed, strategy,
                                 transmittance_fn)


def li_whitted(scene, ray: Ray, pixel, sidx, max_depth: int = 5, seed: int = 0,
               transmittance_fn=None):
    """Whitted integrator (reference integrators/whitted.cpp:40):
    all-light direct + specular recursion."""
    return _li_direct_or_whitted(scene, ray, pixel, sidx, max_depth, seed, "all",
                                 transmittance_fn)


def _li_direct_or_whitted(scene, ray, pixel, sidx, max_depth, seed, strategy,
                          transmittance_fn):
    from pbrt_tpu_torch.scene.compile import eval_bsdf_params

    N = ray.o.shape[0]
    dev = ray.o.device
    zero = torch.zeros((), device=dev)
    st = PathState(
        ray_o=ray.o, ray_d=ray.d,
        throughput=torch.ones((N, S), device=dev),
        L=torch.zeros((N, S), device=dev),
        alive=torch.ones((N,), dtype=torch.bool, device=dev),
        prev_bsdf_pdf=torch.zeros((N,), device=dev),
        prev_specular=torch.ones((N,), dtype=torch.bool, device=dev),
        lam_nm=torch.full((N,), -1.0, device=dev),
    )
    tm = ray.time

    def u(depth, dim):
        return iu(pixel, sidx, depth, dim, seed)

    for depth in range(max_depth + 1):
        hit = scene.intersect(Ray(st.ray_o, st.ray_d, torch.zeros((N,), device=dev),
                                  torch.where(st.alive, torch.full((), BIG, device=dev),
                                              torch.full((), -1.0, device=dev)), tm),
                              coherent=depth == 0)
        st = st._replace(L=_add_hit_emission(scene, st, hit, depth == 0))
        st = st._replace(L=_add_escape_emission(scene, st, st.alive & ~hit.valid, True))
        alive = st.alive & hit.valid
        if depth == max_depth:
            break
        lobes = material_lobes(eval_bsdf_params(scene, hit))
        frame = shading_frame(scene, hit)
        wo = -normalize(st.ray_d)

        Ld = torch.zeros((N, S), device=dev)
        if scene.n_lights > 0:
            if strategy == "all":
                for li in range(scene.n_lights):
                    lidx = torch.full((N,), li, dtype=torch.int64, device=dev)
                    ls = sample_light(scene.lights, lidx, hit.p, u(depth, 10 + 3 * li),
                                      u(depth, 11 + 3 * li))
                    f = bsdf_f(lobes, frame, wo, ls.wi)
                    cos_i = torch.abs(dot(ls.wi, frame.ns))
                    ok = alive & (ls.pdf > 1e-9) & ~spec.is_black(ls.L) & ~spec.is_black(f)
                    ok = ok & ~_occluded(scene, hit.p, ls.wi, ls.dist, ok, time=tm)
                    c = f * ls.L * (cos_i / torch.clamp(ls.pdf, min=1e-12))[..., None]
                    if transmittance_fn is not None:
                        c = c * transmittance_fn(hit.p, ls.wi, ls.dist)
                    Ld = Ld + torch.where(ok[..., None], c, zero)
            else:
                Ld = estimate_direct(scene, lobes, frame, hit.p, wo, u(depth, 0), u(depth, 1),
                                     u(depth, 2), alive, transmittance_fn=transmittance_fn,
                                     time=tm)
        st = st._replace(L=st.L + st.throughput * Ld * alive[..., None])

        # specular continuation only (no u_pick: mix lanes fall back to
        # the scramble of u_lobe, as in the JAX package)
        bs = bsdf_sample(lobes, frame, wo, u(depth, 4), u(depth, 5), u(depth, 6),
                         u(depth, 7), lam_nm=st.lam_nm)
        cos_i = torch.abs(dot(bs.wi, frame.ns))
        tp_new = st.throughput * bs.f * (cos_i / torch.clamp(bs.pdf, min=1e-12))[..., None]
        alive = alive & bs.valid & bs.is_specular & ~spec.is_black(tp_new)
        st = PathState(
            ray_o=hit.p + bs.wi * RAY_EPS, ray_d=bs.wi,
            throughput=torch.where(alive[..., None], tp_new, zero),
            L=st.L, alive=alive, prev_bsdf_pdf=bs.pdf,
            prev_specular=torch.ones((N,), dtype=torch.bool, device=dev),
            lam_nm=st.lam_nm,
        )
    return st.L


def li_ao(scene, ray: Ray, pixel, sidx, n_samples: int = 4, max_dist: float = BIG,
          seed: int = 0):
    """Ambient occlusion (reference integrators/ambientocclusion.cpp
    :65-66: nsamples cosine rays, maxdist)."""
    N = ray.o.shape[0]
    dev = ray.o.device
    hit = scene.intersect(ray)
    frame = make_frame(hit)
    frame = frame._replace(ns=torch.where((dot(frame.ns, -ray.d) < 0)[..., None],
                                          -frame.ns, frame.ns))
    acc = torch.zeros((N,), device=dev)
    for i in range(n_samples):
        wi = frame.to_world(cosine_sample_hemisphere(iu(pixel, sidx, i, 0, seed),
                                                     iu(pixel, sidx, i, 1, seed)))
        dist = torch.full((N,), max_dist, device=dev)
        occ = _occluded(scene, hit.p, wi, dist, hit.valid, time=ray.time)
        acc = acc + (hit.valid & ~occ).to(torch.float32)
    vis = acc / n_samples
    return torch.where(hit.valid[..., None], vis[..., None] * torch.ones((N, S), device=dev),
                       torch.zeros((), device=dev))
