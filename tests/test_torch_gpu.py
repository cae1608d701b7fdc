"""Card tests of the CUDA kernels (K1, K2) and of the main path on CUDA.

The kernels have no CPU mode, so these tests need a CUDA card and skip
without one; whether there is a card is decided inside the fixture.
Run them on the card with:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances: the kernels are built with -fmad=false, so each multiply
and add rounds like the plain torch twin; prim ids must be identical and
t within 1e-5 relative. The card render is held against the CPU render
(plain twins) with the whole-slice limits of tests/test_torch_slice.py;
the film deposit on CUDA is an atomic add whose order varies.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tris(n, seed, device):
    rng = np.random.RandomState(seed)
    c = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    return [torch.as_tensor(x, device=device) for x in (c - (e1 + e2) / 3, e1, e2)]


def _rays(n, seed, device):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.full(n, np.inf, np.float32)
    tmax[: n // 8] = -1.0
    tmax[n // 8: n // 4] = 2.0
    return [torch.as_tensor(x, device=device) for x in (o, d, np.zeros(n, np.float32), tmax)]


def _same(t, p, t_ref, p_ref):
    torch.cuda.synchronize()
    assert torch.equal(p.long().cpu(), p_ref.long().cpu())
    hit = (p_ref >= 0).cpu()
    assert hit.float().mean() > 0.05
    torch.testing.assert_close(t.cpu()[hit], t_ref.cpu()[hit], rtol=1e-5, atol=0)


def test_k1_kernel_matches_plain(cuda):
    from pbrt_tpu_torch.ops import intersect_cuda as k1

    soa = k1.TriSoA(*_tris(3000, 1, cuda))
    rays8 = k1.make_rays8(*_rays(20000, 2, cuda))
    before = k1.launches
    t, p = k1.tri_t_pass_cuda(rays8, soa.tris9, soa.n)
    assert k1.launches == before + 1
    _same(t, p, *k1.tri_t_pass_plain(rays8, soa.tris9, soa.n))
    with pytest.raises(ValueError):
        k1.tri_t_pass_cuda(rays8.double(), soa.tris9, soa.n)


def test_k2_kernel_matches_plain_and_brute(cuda):
    from pbrt_tpu_torch.accel.bvh import build_bvh
    from pbrt_tpu_torch.accel.intersect import SceneGeom, t_pass_brute
    from pbrt_tpu_torch.accel.wide_bvh import build_wide_bvh
    from pbrt_tpu_torch.core.geometry import Ray
    from pbrt_tpu_torch.ops import bvh_cuda

    v0, e1, e2 = _tris(20000, 3, cuda)
    host = [x.cpu().numpy() for x in (v0, e1, e2)]
    wb = build_wide_bvh(build_bvh(*host), *host, cuda)
    o, d, tmin, tmax = _rays(30000, 4, cuda)
    real = bvh_cuda.wide_sweep
    checked = []

    def both(pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc):
        t_ref, p_ref = t_acc.clone(), p_acc.clone()
        bvh_cuda.wide_sweep_plain(pair_block, start, count, rays8, tris16, sentinel,
                                  t_ref, p_ref)
        bvh_cuda.wide_sweep_cuda(pair_block, start, count, rays8, tris16, sentinel,
                                 t_acc, p_acc)
        torch.cuda.synchronize()
        assert torch.equal(p_acc, p_ref)
        torch.testing.assert_close(t_acc, t_ref, rtol=1e-5, atol=0)
        checked.append(int(count.sum()))
        return t_acc, p_acc

    try:
        bvh_cuda.wide_sweep = both
        t, p = bvh_cuda.wide_t_pass(wb, o, d, tmin, tmax)
    finally:
        bvh_cuda.wide_sweep = real
    assert sum(checked) > 0
    geom = SceneGeom(v0, e1, e2, *([None] * 8))
    _same(t, p, *t_pass_brute(geom, Ray(o, d, tmin, tmax, torch.zeros_like(tmin))))


def test_render_on_card_matches_cpu(cuda, tmp_path):
    from pbrt_tpu_torch.ops import intersect_cuda
    from pbrt_tpu_torch.scene import api, parser

    quad = "[-1 0 -1  1 0 -1  1 0 1  -1 0 1]"
    text = (
        'Film "image" "integer xresolution" [32] "integer yresolution" [32]\n'
        'Sampler "lowdiscrepancy" "integer pixelsamples" [4]\n'
        'LookAt 0 1.5 -5  0 0.3 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
        'SurfaceIntegrator "path" "integer maxdepth" [3]\nWorldBegin\n'
        'LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]\n'
        'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [6 6 6]\nTranslate 0 3 0\n'
        f'Shape "trianglemesh" "integer indices" [0 2 1 0 3 2] "point P" {quad}\n'
        'AttributeEnd\n'
        'AttributeBegin\nMaterial "glass" "float index" [1.5] "float Vn" [40]\n'
        'Translate 0 1 0\nScale 0.5 0.5 0.5\n'
        'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3 0 3 1 1 3 2] '
        '"point P" [0 1 0  -1 -1 1  1 -1 1  0 -1 -1]\nAttributeEnd\n'
        'Material "plastic" "rgb Kd" [.5 .4 .3]\nScale 4 1 4\n'
        f'Shape "trianglemesh" "integer indices" [0 2 1 0 3 2] "point P" {quad}\n'
        "WorldEnd\n")
    path = tmp_path / "scene.pbrt"
    path.write_text(text)

    def render(device):
        api.pbrt_init({"quiet": True, "write": False, "device": device,
                       "tile_samples": 4096})
        try:
            parser.parse_file(str(path))
            return np.asarray(api._state.output)
        finally:
            api._state.__init__()

    before = intersect_cuda.launches
    gpu = render("cuda")
    assert intersect_cuda.launches > before
    cpu = render("cpu")
    assert np.isfinite(gpu).all() and gpu.mean() > 0
    assert abs(gpu.mean() - cpu.mean()) <= 5e-3 * cpu.mean()
    rel = (np.abs(gpu - cpu) / np.maximum(np.abs(cpu), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99
