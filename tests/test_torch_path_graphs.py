"""The path loop split at its traversals (integrators/surface.py), on
the CPU: the calls that stay eager, with no `path/graph` span (the
rule for where stretches replay: tests/test_torch_graphs.py);
fresnel_dielectric's scalar eta_i; estimate_direct's two halves against
the whole it was before the split, with and without MIS. The graphs
themselves run on the card: tests/test_torch_gpu.py holds them bit for
bit against the eager stretches.

The scene: an area light, an infinite light and a point light over
plastic, metal and substrate, 16 x 16 at 1 spp.
"""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.core import graphs as cuda_graphs
from pbrt_tpu_torch.core import probes
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.core.geometry import dot, normalize
from pbrt_tpu_torch.core.sampling import power_heuristic
from pbrt_tpu_torch.integrators import surface
from pbrt_tpu_torch.materials import bsdf
from pbrt_tpu_torch.samplers.samplers import (camera_samples, integrator_base,
                                              integrator_uniform, integrator_uniform_at,
                                              make_sampler)
from pbrt_tpu_torch.scene import api, parser
from pbrt_tpu_torch.scene.compile import compile_scene, eval_bsdf_params

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

_QUAD = '"integer indices" [0 2 1 0 3 2] "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]'
SCENE = f"""Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
LookAt 0 1.5 -5  0 0.3 0  0 1 0
Camera "perspective" "float fov" [45]
SurfaceIntegrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "infinite" "rgb L" [.3 .35 .4]
LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [6 6 6]
Translate 0 3 0
Shape "trianglemesh" {_QUAD}
AttributeEnd
AttributeBegin
Material "metal" "float roughness" [0.05]
Translate -1 0.8 0
Shape "sphere" "float radius" [0.7]
AttributeEnd
AttributeBegin
Material "substrate" "rgb Kd" [.4 .2 .1]
Translate 1 0.8 0
Shape "sphere" "float radius" [0.7]
AttributeEnd
Material "plastic" "rgb Kd" [.5 .4 .3]
Scale 4 1 4
Shape "trianglemesh" {_QUAD}
WorldEnd
"""


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    from pbrt_tpu_torch.cameras.cameras import make_camera
    from pbrt_tpu_torch.film import film as film_mod

    path = tmp_path_factory.mktemp("graphs") / "scene.pbrt"
    path.write_text(SCENE)
    kept = {}

    class Capture:
        def __getattr__(self, name):
            return getattr(api, name)

        def pbrt_world_end(self):
            kept["ro"] = api.get_state().render_options
            api.pbrt_world_end(render=False)

    api.pbrt_init({"quiet": True})
    try:
        parser.parse_file(str(path), api=Capture())
    finally:
        api._state.__init__()
    ro = kept["ro"]
    scene = compile_scene(ro, "cpu")
    film = film_mod.make_film(ro.film_name, ro.film_params,
                              film_mod.make_filter(ro.filter_name, ro.filter_params), {})
    camera = make_camera(ro.camera_name, ro.camera_params, ro.camera_to_world, film.xres,
                         film.yres)
    ids = torch.arange(film.nx * film.ny)
    cs = camera_samples(make_sampler(ro.sampler_name, ro.sampler_params, {}),
                        ids % film.nx, ids // film.nx, film.xres, 5)
    ray, _ = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
    return scene, ray, cs.pixel, torch.zeros_like(cs.pixel)


def _graph_spans(fn):
    probes.reset()
    probes.enable(True)
    try:
        out = fn()
    finally:
        probes.enable(False)
    names = [s.name for s in probes.spans()]
    probes.reset()
    return out, names


@pytest.mark.parametrize("how", ["cpu", "medium", "psamples"])
def test_the_cpu_a_medium_and_mlt_replay_nothing(compiled, monkeypatch, how):
    """Each renders through the same stretches, eagerly: the image is
    the one the eager loop gives, with no path/graph span; only li_path
    without a medium asks the rule, which answers EAGER off a card."""
    scene, ray, pixel, sidx = compiled
    asked = []
    real = cuda_graphs.graphs_for
    monkeypatch.setattr(cuda_graphs, "graphs_for", lambda *a: asked.append(a[1]) or real(*a))
    if how == "cpu":
        L, names = _graph_spans(lambda: surface.li_path(scene, ray, pixel, sidx, 3, seed=4))
    elif how == "medium":
        L, names = _graph_spans(lambda: surface.li_path(
            scene, ray, pixel, sidx, 3, seed=4,
            transmittance_fn=lambda p, wi, d: torch.full((p.shape[0], spec.N_BINS), 0.5)))
    else:
        u = torch.rand((ray.o.shape[0], 40), generator=torch.Generator().manual_seed(1))
        L, names = _graph_spans(lambda: surface.li_path_psamples(scene, ray, u, 3))
    assert L.shape == (ray.o.shape[0], spec.N_BINS) and float(L.sum()) > 0
    assert "path/graph" not in names
    assert names.count("path/bounce") == 4 and names.count("path/direct") == 3
    assert asked == ([surface.PathGraphs] if how == "cpu" else [])
    assert not scene.graphs


def test_the_split_uniforms_are_integrator_uniform():
    g = torch.Generator().manual_seed(3)
    pixel = torch.randint(0, 2**32, (512,), generator=g)
    sidx = torch.randint(0, 64, (512,), generator=g)
    for seed in (0, 7, 2**31 + 5):
        base = integrator_base(pixel, sidx, seed)
        for depth, dim in ((0, 0), (3, 9), (5, 4)):
            assert torch.equal(integrator_uniform_at(base, depth, dim),
                               integrator_uniform(pixel, sidx, depth, dim, seed))


def test_fresnel_dielectric_float_eta_is_the_tensor_form():
    g = torch.Generator().manual_seed(2)
    cos_i = torch.rand((4096,), generator=g) * 2 - 1
    eta_t = 1.0 + torch.rand((4096,), generator=g)
    for eta_i in (1.0, 1.33):
        a = bsdf.fresnel_dielectric(cos_i, eta_i, eta_t)
        b = bsdf.fresnel_dielectric(cos_i, torch.tensor(eta_i, dtype=torch.float32), eta_t)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert 0 < float(a.mean()) < 1


def _whole_estimate_direct(scene, lobes, frame, p, wo, u_light, u1, u2, active, time, mis):
    """estimate_direct as one function, as it was before the split."""
    from pbrt_tpu_torch.lights.lighting import sample_light

    light_idx, pick_pmf = scene.light_dist.sample_discrete(u_light)
    ls = sample_light(scene.lights, light_idx, p, u1, u2)
    f = bsdf.bsdf_f(lobes, frame, wo, ls.wi)
    cos_i = torch.abs(dot(ls.wi, frame.ns))
    usable = (active & (cos_i > 0) & (ls.pdf > 1e-9) & ~spec.is_black(ls.L)
              & ~spec.is_black(f))
    usable = usable & ~surface._occluded(scene, p, ls.wi, ls.dist, usable, time=time)
    if mis:
        bpdf = bsdf.bsdf_pdf(lobes, frame, wo, ls.wi)
        w = torch.where(ls.is_delta, torch.ones(()),
                        power_heuristic(1.0, ls.pdf * pick_pmf, 1.0, bpdf))
    else:
        w = torch.ones_like(cos_i)
    contrib = f * ls.L * (cos_i * w / torch.clamp(ls.pdf * pick_pmf, min=1e-12))[..., None]
    return torch.where(usable[..., None], contrib, torch.zeros(()))


@pytest.mark.parametrize("mis", [True, False])
def test_split_estimate_direct_is_the_whole(compiled, mis):
    scene, ray, pixel, sidx = compiled
    hit = scene.intersect(ray, coherent=True)
    lobes = bsdf.material_lobes(eval_bsdf_params(scene, hit))
    frame = surface.shading_frame(scene, hit)
    wo = -normalize(ray.d)
    u = [integrator_uniform(pixel, sidx, 0, d, 9) for d in range(3)]
    args = (scene, lobes, frame, hit.p, wo, *u, hit.valid)
    ds = surface.sample_direct(*args, time=ray.time)
    occluded = scene.intersect_p(ds.ray, coherent=True)
    split = surface.finish_direct(scene, lobes, frame, hit.p, wo, ds, occluded, mis=mis)
    whole = _whole_estimate_direct(*args, ray.time, mis)
    public = surface.estimate_direct(*args, time=ray.time, mis=mis)
    assert float(whole.sum()) > 0 and int(occluded.sum()) > 0
    for got in (split, public):
        assert torch.equal(got.view(torch.int32), whole.view(torch.int32))
