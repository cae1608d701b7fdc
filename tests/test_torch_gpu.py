"""Card tests of the CUDA kernels (K1, K2) and of the main path on CUDA.

The kernels have no CPU mode, so these tests need a CUDA card and skip
without one; whether there is a card is decided inside the fixture.
Run them on the card with:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

Tolerances: the kernels are built with -fmad=false, so each multiply
and add rounds like the plain torch twin; prim ids must be identical and
t bit-equal (K1, K2 on its adversarial pairs; K2 inside wide_t_pass:
within 1e-5 relative). The card render is held against the CPU render
(plain twins) with the whole-slice limits of tests/test_torch_slice.py;
the film deposit on CUDA is an atomic add whose order varies.
"""
import numpy as np
import pytest
import torch

from test_torch_photon_graphs import _maps_equal

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

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


def adversarial_k1_case(n_rays, n_tris, seed, dead="half"):
    """K1 inputs built to catch a decomposition that breaks the tie rule
    or the dead-ray skip. NumPy: (rays8 [n_rays, 8], tris9 [9, Tpad],
    n_tris, info).

      random triangles, with triangle b*256 - 3 copied to b*256 + 5 at
        every stage boundary b and triangle 0 copied to the last slot, so
        hits tie at equal t in different stages; a fifth of the rays aim
        at those copies;
      four triangles in planes far from the rest, in two pairs whose hits
        are t = -0.0 (det < 0) and t = +0.0 (det > 0): at x = 20 the -0.0
        triangle comes first, at x = -24 last; 64 rays start inside them
        with tmin = -1;
      dead rays (tmax -1, tmin = tmax, NaN tmin, tmin > tmax): about half
        the rays (dead="half") or all of them ("all"); among the live,
        zero directions and a short tmax.

    info: dup_src, dup_dst (the copies' indices), neg_zero / pos_zero
    (the rays whose least hit is -0.0 / +0.0) and dead (masks)."""
    rng = np.random.RandomState(seed)
    c = rng.uniform(-5, 5, (n_tris, 3))
    e1 = rng.normal(0, 0.5, (n_tris, 3))
    e2 = rng.normal(0, 0.5, (n_tris, 3))
    tri = np.concatenate([c - (e1 + e2) / 3, e1, e2], -1).astype(np.float32)   # [n, 9]
    # the -0.0 / +0.0 pairs (dyadic values: the arithmetic is exact)
    flat_neg = [20, 20, 0, 4, 0, 0, 0, 4, 0]     # d = +z: det = -16, t = -0.0
    flat_pos = [20, 20, 0, 0, 4, 0, 4, 0, 0]     # det = +16, t = +0.0
    flat = {1: flat_neg, n_tris - 2: flat_pos,
            2: [-24, 20, 0, 0, 4, 0, 4, 0, 0], n_tris - 3: [-24, 20, 0, 4, 0, 0, 0, 4, 0]}
    src = [b * 256 - 3 for b in range(1, (n_tris + 255) // 256) if b * 256 + 5 < n_tris - 3]
    src, dst = src + [0], [s + 8 for s in src] + [n_tris - 1]
    tri[dst] = tri[src]
    for i, v in flat.items():
        tri[i] = v
    tris9 = np.zeros((9, max(256, -(-n_tris // 256) * 256)), np.float32)
    tris9[:, :n_tris] = tri.T

    o = rng.uniform(-6, 6, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    aim = rng.rand(n_rays) < 0.2
    target = rng.choice(src, n_rays)
    cen = tri[target, 0:3] + (tri[target, 3:6] + tri[target, 6:9]) / 3
    d[aim] = cen[aim] - o[aim]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[rng.rand(n_rays) < 1 / 16] = 0.0                 # zero directions
    tmin = np.zeros(n_rays)
    tmax = np.where(rng.rand(n_rays) < 1 / 8, 3.0, np.inf)   # short tmax
    # rays inside the flat pairs, along +z, tmin < 0
    k = min(64, n_rays // 4)
    fl = rng.choice(n_rays, k, replace=False)
    x0 = np.where(np.arange(k) % 2 == 0, 20.0, -24.0)
    du = rng.choice([0.25, 0.5, 1.0, 1.5], (k, 2))
    o[fl] = np.stack([x0 + du[:, 0], 20.0 + du[:, 1], np.zeros(k)], -1)
    d[fl] = [0.0, 0.0, 1.0]
    tmin[fl], tmax[fl] = -1.0, np.inf
    is_flat = np.zeros(n_rays, bool)
    is_flat[fl] = True
    dead_mask = (rng.rand(n_rays) < 0.5) & ~is_flat if dead == "half" else np.ones(n_rays, bool)
    kind = rng.randint(0, 4, n_rays)
    tmax[dead_mask & (kind == 0)] = -1.0
    tmin[dead_mask & (kind == 1)] = tmax[dead_mask & (kind == 1)] = 2.0
    tmin[dead_mask & (kind == 2)] = np.nan
    tmin[dead_mask & (kind == 3)], tmax[dead_mask & (kind == 3)] = 5.0, 3.0
    rays8 = np.concatenate([o, d, tmin[:, None], np.minimum(tmax, 1e30)[:, None]],
                           -1).astype(np.float32)
    live_flat = is_flat & ~dead_mask
    info = {"dup_src": np.array(src), "dup_dst": np.array(dst), "dead": dead_mask,
            "neg_zero": live_flat & (o[:, 0] > 0), "pos_zero": live_flat & (o[:, 0] < 0)}
    return rays8, tris9, n_tris, info


def adversarial_sweep_case(device, n_tiles=64, seed=11):
    """K2 inputs at the render's shape (64 tiles of 1024 rays per
    traversal) built to catch a merge that breaks list order:

      tile 0: a full MAX_L run of distinct leaf blocks;
      tiles 1, 2: identical blocks A and B (A also repeats a triangle in
        two slots), listed A B and B A, so every hit ties across pairs;
      tile 3: one block whose hit t equals the starting accumulator of
        half its rays, which must keep their prim;
      tile 4: sentinel, real, sentinel;  tile 5: empty;
      the rest: 0 or 1 pair.

    Every tile has dead rays (t_acc = -1e30), rays with a short tmax and
    rays with a finite starting t. Returns the arguments of wide_sweep
    on `device`, with the rays of tile 3 that must keep their prim."""
    from pbrt_tpu_torch.accel.wide_bvh import LEAF_W, MAX_L, TILE
    from pbrt_tpu_torch.ops import bvh_cuda

    rng = np.random.RandomState(seed)
    n_blocks = MAX_L + 6
    sentinel = n_blocks
    n = n_blocks * LEAF_W
    L = rng.uniform(0.3, 3.0, n)
    v0 = np.stack([-L + rng.uniform(-0.5, 0.5, n), -L + rng.uniform(-0.5, 0.5, n),
                   rng.uniform(-5, 5, n)], -1)
    e1 = np.stack([3 * L, np.zeros(n), rng.uniform(-0.5, 0.5, n)], -1)
    e2 = np.stack([np.zeros(n), 3 * L, rng.uniform(-0.5, 0.5, n)], -1)
    tris16 = np.zeros((16, (n_blocks + 1) * LEAF_W), np.float32)
    tris16[0:9, :n] = np.concatenate([v0, e1, e2], -1).T
    blk_a, blk_b = n_blocks - 2, n_blocks - 1
    a = slice(blk_a * LEAF_W, (blk_a + 1) * LEAF_W)
    tris16[:, a.start + 77] = tris16[:, a.start + 13]
    tris16[:, blk_b * LEAF_W:(blk_b + 1) * LEAF_W] = tris16[:, a]

    R = n_tiles * TILE
    o = np.stack([rng.uniform(-1, 1, R), rng.uniform(-1, 1, R), np.full(R, -10.0)], -1)
    d = np.stack([rng.normal(0, 0.05, R), rng.normal(0, 0.05, R), np.ones(R)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmax = np.where(rng.rand(R) < 0.125, 9.0, bvh_cuda.BIG)
    rays8 = np.concatenate([o, d, np.zeros((R, 1)), tmax[:, None]], -1).astype(np.float32)
    t_acc = np.where(rng.rand(R) < 0.25, rng.uniform(6, 16, R), bvh_cuda.BIG)
    t_acc[rng.rand(R) < 0.125] = -bvh_cuda.BIG
    t_acc = t_acc.astype(np.float32)
    p_acc = np.full(R, -1, np.int32)

    others = rng.permutation(n_blocks - 2)
    runs = [list(others[:MAX_L]), [blk_a, blk_b], [blk_b, blk_a], [others[MAX_L]],
            [sentinel, others[MAX_L + 1], sentinel], []]
    runs += [list(rng.choice(n_blocks, rng.randint(0, 2))) for _ in range(n_tiles - 6)]
    runs = runs[:n_tiles]
    count = np.array([len(r) for r in runs], np.int32)
    start = (np.cumsum(count) - count).astype(np.int32)
    pair_block = np.array([b for r in runs for b in r], np.int32)

    # tile 3: start half of its hit rays at exactly their hit t
    sl = slice(3 * TILE, 4 * TILE)
    t3 = torch.full((TILE,), bvh_cuda.BIG)
    p3 = torch.full((TILE,), -1, dtype=torch.int32)
    bvh_cuda.wide_sweep_plain(*(torch.as_tensor(x) for x in (
        np.array(runs[3], np.int32), np.zeros(1, np.int32), np.ones(1, np.int32),
        rays8[sl], tris16)), sentinel, t3, p3)
    tie = (p3.numpy() >= 0) & (np.arange(TILE) % 2 == 0)
    t_acc[sl][tie] = t3.numpy()[tie]
    p_acc[sl][tie] = 424242
    keep = np.zeros(R, bool)
    keep[sl] = tie

    args = [torch.as_tensor(x, device=device) for x in (pair_block, start, count, rays8, tris16)]
    return (*args, sentinel, torch.as_tensor(t_acc, device=device),
            torch.as_tensor(p_acc, device=device)), torch.as_tensor(keep)


def _same(t, p, t_ref, p_ref):
    torch.cuda.synchronize()
    assert torch.equal(p.long().cpu(), p_ref.long().cpu())
    hit = (p_ref >= 0).cpu()
    assert hit.float().mean() > 0.05
    torch.testing.assert_close(t.cpu()[hit], t_ref.cpu()[hit], rtol=1e-5, atol=0)


def _bit_equal(t, p, t_ref, p_ref):
    torch.cuda.synchronize()
    assert torch.equal(p.long().cpu(), p_ref.long().cpu())
    assert torch.equal(t.view(torch.int32).cpu(), t_ref.view(torch.int32).cpu())


def test_k1_kernel_matches_plain(cuda):
    from pbrt_tpu_torch.ops import intersect_cuda as k1

    soa = k1.TriSoA(*_tris(3000, 1, cuda))
    rays8 = k1.make_rays8(*_rays(20000, 2, cuda))
    before = k1.launches
    t, p = k1.tri_t_pass_cuda(rays8, soa.tris9, soa.n)
    assert k1.launches == before + 1
    t_ref, p_ref = k1.tri_t_pass_plain(rays8, soa.tris9, soa.n)
    assert (p_ref >= 0).float().mean() > 0.05
    _bit_equal(t, p, t_ref, p_ref)
    with pytest.raises(ValueError):
        k1.tri_t_pass_cuda(rays8.double(), soa.tris9, soa.n)
    with pytest.raises(ValueError):  # misaligned rows
        k1.tri_t_pass_cuda(rays8.view(-1)[2:2 + 8 * 100].view(100, 8), soa.tris9, soa.n)


def test_k1_kernel_matches_plain_on_adversarial_case(cuda):
    """The redesigned K1 (live rays only, items over the whole card,
    merged by key) at the small render's shape, 65,536 rays x 7,204
    triangles: ties across stages, -0.0 and +0.0 hits, half the rays
    dead. prim identical and t bit-equal to the plain twin; one launch
    counted per call. An all-dead set returns misses."""
    from pbrt_tpu_torch.ops import intersect_cuda as k1

    for dead in ("half", "all"):
        rays8, tris9, n, info = adversarial_k1_case(1 << 16, 7204, seed=31, dead=dead)
        rays8, tris9 = torch.as_tensor(rays8, device=cuda), torch.as_tensor(tris9, device=cuda)
        before = k1.launches
        t, p = k1.tri_t_pass_cuda(rays8, tris9, n)
        assert k1.launches == before + 1
        t_ref, p_ref = k1.tri_t_pass_plain(rays8, tris9, n)
        _bit_equal(t, p, t_ref, p_ref)
        p = p.cpu().numpy()
        assert (p[info["dead"]] == -1).all()
        if dead == "half":
            bits = t.view(torch.int32).cpu().numpy()
            assert info["neg_zero"].sum() > 10 and (bits[info["neg_zero"]] == -(1 << 31)).all()
            assert info["pos_zero"].sum() > 10 and (bits[info["pos_zero"]] == 0).all()
            assert np.isin(p, info["dup_src"]).sum() > 100 and not np.isin(p, info["dup_dst"]).any()
        else:
            assert (p == -1).all()


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


def test_k2_kernel_matches_plain_on_adversarial_pairs(cuda):
    """The redesigned K2 (items over the whole card, merged by key) at
    the render's shape on the adversarial pair list: prim identical and
    t equal to the sequential fold."""
    from pbrt_tpu_torch.ops import bvh_cuda

    args, keep = adversarial_sweep_case(cuda)
    *inputs, t0, p0 = args
    t_ref, p_ref = bvh_cuda.wide_sweep_plain(*inputs, t0.clone(), p0.clone())
    t, p = t0.clone(), p0.clone()
    before = bvh_cuda.launches
    bvh_cuda.wide_sweep_cuda(*inputs, t, p)
    assert bvh_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(p, p_ref)
    assert torch.equal(t.view(torch.int32), t_ref.view(torch.int32))
    assert bool((p[keep.to(cuda)] == 424242).all()) and int(keep.sum()) > 50
    assert int((p != p0).sum()) > 10000


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


def test_quadric_scene_on_card_matches_cpu(cuda, tmp_path):
    """The meshdl golden (two floor triangles through K1, three quadrics
    folded in after it, a tessellated disk light, directlighting) with a
    homogeneous volume added (single scattering), on the card and on the
    CPU, within the whole-slice limits."""
    import os

    from pbrt_tpu_torch.ops import intersect_cuda
    from pbrt_tpu_torch.scene import api, parser

    with open(os.path.join(os.path.dirname(__file__), "goldens", "meshdl.pbrt")) as f:
        text = f.read()
    text = text.replace('"integer pixelsamples" [16]', '"integer pixelsamples" [4]')
    text = text.replace("WorldBegin", 'VolumeIntegrator "single" "float stepsize" [0.5]\n'
                        "WorldBegin\n"
                        'Volume "homogeneous" "point p0" [-3 0 -3] "point p1" [3 3 3] '
                        '"rgb sigma_a" [.05 .05 .05] "rgb sigma_s" [.1 .1 .1]', 1)
    path = tmp_path / "scene.pbrt"
    path.write_text(text)

    def render(device):
        api.pbrt_init({"quiet": True, "write": False, "device": device})
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


# ---------------------------------------------------------------------------
# The path loop's CUDA graphs (integrators/surface.py PathGraphs): each
# scene's tiles through li_path with the graphs and with the same
# stretches run eagerly, bit for bit, lane for lane

GLASS = """Film "image" "integer xresolution" [64] "integer yresolution" [64]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
SurfaceIntegrator "path" "integer maxdepth" [5]
WorldBegin
LightSource "point" "point from" [2 4 -4] "rgb I" [20 20 20]
AttributeBegin
  Material "glass" "float index" [1.52] "float Vn" [30]
  Shape "sphere" "float radius" [1]
AttributeEnd
AttributeBegin
  Translate 0 -1.2 0  Rotate -90 1 0 0
  Material "matte" "rgb Kd" [.6 .3 .2]
  Shape "disk" "float radius" [4]
AttributeEnd
WorldEnd
"""

_QUAD = '"integer indices" [0 2 1 0 3 2] "point P" [-1 0 -1  1 0 -1  1 0 1  -1 0 1]'

LIGHTS = f"""Film "image" "integer xresolution" [64] "integer yresolution" [64]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
LookAt 0 1.5 -5  0 0.3 0  0 1 0
Camera "perspective" "float fov" [45]
SurfaceIntegrator "path" "integer maxdepth" [4]
WorldBegin
LightSource "infinite" "rgb L" [.3 .35 .4]
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

TEXTURED = f"""Film "image" "integer xresolution" [64] "integer yresolution" [64]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
LookAt 0 1.5 -5  0 0.3 0  0 1 0
Camera "perspective" "float fov" [45]
SurfaceIntegrator "path" "integer maxdepth" [3]
WorldBegin
LightSource "point" "point from" [2 4 -3] "rgb I" [15 15 15]
Texture "img" "color" "imagemap" "string filename" ["tex.pfm"]
Texture "chk" "color" "checkerboard" "float uscale" [4] "float vscale" [4] "rgb tex1" [.8 .8 .8] "rgb tex2" [.1 .1 .1]
Texture "bmp" "float" "wrinkled" "float scale" [0.02]
MakeNamedMaterial "a" "string type" ["matte"] "texture Kd" ["img"]
MakeNamedMaterial "b" "string type" ["plastic"] "texture Kd" ["chk"]
AttributeBegin
Material "mix" "string namedmaterial1" ["a"] "string namedmaterial2" ["b"] "rgb amount" [.3 .5 .7]
Translate -1 0.8 0
Shape "sphere" "float radius" [0.7]
AttributeEnd
AttributeBegin
Material "matte" "texture Kd" ["img"] "texture bumpmap" ["bmp"]
Translate 1 0.8 0
Shape "sphere" "float radius" [0.7]
AttributeEnd
Material "matte" "texture Kd" ["chk"]
Scale 4 1 4
Shape "trianglemesh" {_QUAD} "float uv" [0 0 1 0 1 1 0 1]
WorldEnd
"""


def _bench_mesh_text():
    """The sphere135k geometry (scripts/bench_scene.py): a 260 x 260 UV
    sphere over a floor, matte, one point light, path at depth 5."""
    from scripts.bench_scene import uv_sphere

    P, idx = uv_sphere(260, 260, 1.0, (0.0, 0.4, 0.0))
    floor = "[-12 -0.6 -12  12 -0.6 -12  12 -0.6 12  -12 -0.6 12]"
    return ('Film "image" "integer xresolution" [64] "integer yresolution" [64]\n'
            'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n'
            'LookAt 0 1.2 -4  0 0.4 0  0 1 0\nCamera "perspective" "float fov" [45]\n'
            'SurfaceIntegrator "path" "integer maxdepth" [5]\nWorldBegin\n'
            'LightSource "point" "point from" [3 6 -4] "rgb I" [60 60 60]\n'
            'Material "matte" "rgb Kd" [.45 .35 .65]\n'
            'Shape "trianglemesh" "integer indices" [' + " ".join(map(str, idx.tolist()))
            + '] "point P" [' + " ".join(f"{v:.6f}" for v in P.ravel()) + "]\n"
            'Material "matte" "rgb Kd" [.55 .55 .5]\n'
            f'Shape "trianglemesh" "integer indices" [0 2 1 0 3 2] "point P" {floor}\n'
            "WorldEnd\n")


def _write_texture(path):
    img = np.full((8, 8, 3), 0.5, np.float32)
    img[::2, ::2] = [0.9, 0.2, 0.1]
    img[1::2, 1::2] = [0.1, 0.3, 0.8]
    with open(path, "wb") as f:
        f.write(b"PF\n8 8\n-1.0\n")
        f.write(img[::-1].astype("<f4").tobytes())


def _compiled(text, tmp_path, device):
    """Scene text -> (RenderOptions, CompiledScene on `device`)."""
    import os

    from pbrt_tpu_torch.scene import api, parser
    from pbrt_tpu_torch.scene.compile import compile_scene

    _write_texture(tmp_path / "tex.pfm")
    path = tmp_path / "scene.pbrt"
    path.write_text(text)
    kept = {}

    class Capture:
        def __getattr__(self, name):
            return getattr(api, name)

        def pbrt_world_end(self):
            kept["ro"] = api.get_state().render_options
            api.pbrt_world_end(render=False)

    cwd = os.getcwd()
    os.chdir(tmp_path)
    api.pbrt_init({"quiet": True})
    try:
        parser.parse_file(str(path), api=Capture())
        return kept["ro"], compile_scene(kept["ro"], device)
    finally:
        api._state.__init__()
        os.chdir(cwd)


def _tile(ro, device, tile, n, seed):
    """The camera rays of tile `tile` (n lanes) of the scene's film."""
    from pbrt_tpu_torch.cameras.cameras import make_camera
    from pbrt_tpu_torch.film import film as film_mod
    from pbrt_tpu_torch.samplers.samplers import camera_samples, make_sampler

    opts = {"seed": seed}
    film = film_mod.make_film(ro.film_name, ro.film_params,
                              film_mod.make_filter(ro.filter_name, ro.filter_params), opts)
    camera = make_camera(ro.camera_name, ro.camera_params, ro.camera_to_world, film.xres,
                         film.yres)
    sampler = make_sampler(ro.sampler_name, ro.sampler_params, opts)
    ids = torch.arange(tile * n, (tile + 1) * n, device=device) % (film.nx * film.ny)
    cs = camera_samples(sampler, ids % film.nx + film.x0, ids // film.nx + film.y0,
                        film.xres, seed)
    ray, _ = camera.generate_rays(cs.px, cs.py, cs.u_lens1, cs.u_lens2, cs.u_time)
    return ray, cs.pixel, torch.zeros((n,), dtype=torch.int64, device=device)


def _graphs_vs_eager(ro, scene, device, monkeypatch, n=2048):
    """Two seeds x two tiles through one key with the graphs, then with
    the same stretches eager -> (graph L, eager L, counters, spans)."""
    from pbrt_tpu_torch.core import graphs as cuda_graphs
    from pbrt_tpu_torch.core import probes
    from pbrt_tpu_torch.integrators import surface

    depth = ro.surf_integrator_params.find_one_int("maxdepth", 5)
    tiles = [(_tile(ro, device, t, n, seed), seed) for seed in (3, 2**31 + 11)
             for t in (0, 1)]

    def render():
        return [surface.li_path(scene, ray, pixel, sidx, max_depth=depth, seed=seed)
                for (ray, pixel, sidx), seed in tiles]

    probes.reset()
    probes.enable(True)
    try:
        graphed = render()
    finally:
        probes.enable(False)
    counters, spans = probes.counters(), probes.spans()
    probes.reset()
    with monkeypatch.context() as m:
        m.setattr(cuda_graphs, "graphs_for", lambda *a: cuda_graphs.EAGER)
        eager = render()
    return depth, graphed, eager, counters, spans


def _assert_bit_equal(graphed, eager):
    for a, b in zip(graphed, eager):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert sum(float(a.sum()) for a in graphed) > 0


@pytest.mark.parametrize("name", ["sphere135k", "glass", "lights", "textured"])
def test_path_graphs_match_the_eager_stretches(cuda, tmp_path, monkeypatch, name):
    """Every lane of L bit-equal to the eager stretches', over two seeds
    and two tiles of one key: 2 x maxdepth + 1 graphs captured once,
    none fallen back, every later bounce replayed (path/graph spans)."""
    text = {"sphere135k": _bench_mesh_text, "glass": lambda: GLASS,
            "lights": lambda: LIGHTS, "textured": lambda: TEXTURED}[name]()
    ro, scene = _compiled(text, tmp_path, cuda)
    depth, graphed, eager, counters, spans = _graphs_vs_eager(ro, scene, cuda, monkeypatch)
    _assert_bit_equal(graphed, eager)
    assert counters.get("path/graph_captures", 0) == 2 * depth + 1
    assert counters.get("path/graph_fallbacks", 0) == 0
    assert list(scene.graphs) == [("path", 2048, depth, 3)]
    names = [s.name for s in spans]
    assert names.count("path/graph") == 4 * (2 * depth + 1)
    assert names.count("path/bounce") == 4 * (depth + 1)


def test_path_graphs_fall_back_when_a_capture_raises(cuda, tmp_path, monkeypatch):
    """A stretch that raises while it is captured (here: stretch B of
    depth 0, whose bsdf_sample refuses a capturing stream) leaves its
    key eager from that stretch on, counted once, with L bit for bit
    the eager stretches'."""
    from pbrt_tpu_torch.integrators import surface

    ro, scene = _compiled(GLASS, tmp_path, cuda)
    real = surface.bsdf_sample

    def refuses_capture(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("refused inside a capture")
        return real(*args, **kwargs)

    monkeypatch.setattr(surface, "bsdf_sample", refuses_capture)
    depth, graphed, eager, counters, spans = _graphs_vs_eager(ro, scene, cuda, monkeypatch)
    _assert_bit_equal(graphed, eager)
    assert counters.get("path/graph_fallbacks", 0) == 1
    assert counters.get("path/graph_captures", 0) == 1     # stretch A of depth 0
    assert [k.failed for k in scene.graphs.values()] == [True]
    # after the fallback a tile replays nothing
    assert [s.name for s in spans].count("path/graph") == 1


def test_path_graphs_refuse_a_stretch_that_syncs(cuda, tmp_path, monkeypatch):
    """A stretch that waits on the card (here: stretch A of depth 0) is
    caught by its warm-up under torch's sync debug mode, before any
    capture."""
    from pbrt_tpu_torch.integrators import surface

    ro, scene = _compiled(GLASS, tmp_path, cuda)
    real = surface.sample_light

    def syncs(lights, light_idx, *args):
        int(light_idx.max())
        return real(lights, light_idx, *args)

    monkeypatch.setattr(surface, "sample_light", syncs)
    depth, graphed, eager, counters, _ = _graphs_vs_eager(ro, scene, cuda, monkeypatch)
    _assert_bit_equal(graphed, eager)
    assert counters.get("path/graph_fallbacks", 0) == 1
    assert counters.get("path/graph_captures", 0) == 0


def test_path_graphs_stay_out_of_a_grad_render(cuda, tmp_path):
    """A grad render of `path` (diff.py's use: a kd_scale that requires
    grad, grad mode on) runs its stretches eagerly from the start: no
    capture, no fallback, no path/graph span, and the gradient flows.
    The same scene under no_grad replays its graphs, with L bit for bit
    the grad render's."""
    from pbrt_tpu_torch import diff
    from pbrt_tpu_torch.core import probes
    from pbrt_tpu_torch.integrators import surface

    ro, scene = _compiled(GLASS, tmp_path, cuda)
    params = diff.default_params(scene, want=("kd_scale",))
    kd = params.kd_scale.requires_grad_()
    sc = diff.apply_params(scene, params._replace(kd_scale=kd))
    ray, pixel, sidx = _tile(ro, cuda, 0, 2048, 3)
    probes.reset()
    probes.enable(True)
    try:
        L = surface.li_path(sc, ray, pixel, sidx, max_depth=5, seed=3)
        grad, = torch.autograd.grad(L.sum(), kd)
    finally:
        probes.enable(False)
    counters, names = probes.counters(), [s.name for s in probes.spans()]
    probes.reset()
    assert not any(k.startswith("path/graph") for k in counters)
    assert "path/graph" not in names and not sc.graphs
    assert bool(torch.isfinite(grad).all()) and float(grad.abs().sum()) > 0
    with torch.no_grad():
        replayed = [surface.li_path(sc, ray, pixel, sidx, max_depth=5, seed=3) for _ in range(2)]
    assert [k[0] for k in sc.graphs] == ["path"] and not next(iter(sc.graphs.values())).failed
    _assert_bit_equal(replayed, [L.detach()] * 2)


# ---------------------------------------------------------------------------
# The photon shoot's CUDA graphs (photon/shooter.py ShootGraphs): each
# scene's build_photon_maps with the graphs and with the same stretches
# run eagerly, bit for bit

def _photon_text(name):
    """rainbowc and disp as they stand; `benchphoton` (chip_smoke.py: the
    bench geometry, so K2 and Phase A traverse) at 16^2 with its quotas
    cut 10x-20x, so that its shoot takes 4,096-path batches."""
    import os

    import chip_smoke

    if name == "benchphoton":
        return (chip_smoke.benchphoton_scene_text(16).replace("[200000]", "[20000]")
                .replace('"integer volumephotons" [1000000]', '"integer volumephotons" [50000]'))
    if name == "rainbowc":
        return chip_smoke.rainbowc_text()
    with open(os.path.join(chip_smoke.GOLDEN_DIR, f"{name}.pbrt")) as f:
        return f.read()


def _shoots(ro, scene, seeds, stores=None):
    """build_photon_maps at each seed, one frame after another ->
    [PhotonCtx]; `stores` collects every part a store keeps, with a copy
    taken when it was added."""
    from pbrt_tpu_torch.photon import shooter

    real_add = shooter._Store.add

    def add(self, idx, *arrays):
        n = len(self.parts)
        real_add(self, idx, *arrays)
        if stores is not None and len(self.parts) > n:
            stores.append((self.parts[-1], tuple(a.clone() for a in self.parts[-1])))

    shooter._Store.add = add
    try:
        return [shooter.build_photon_maps(scene, ro.surf_integrator_params,
                                          ro.vol_integrator_params, {"quiet": True, "seed": s})
                for s in seeds]
    finally:
        shooter._Store.add = real_add


def _photon_graphs_vs_eager(ro, scene, monkeypatch, seeds=(3, 2**31 + 11)):
    """The shoots at `seeds` with the graphs (the second frame replays
    graphs captured under the first seed), then with the same stretches
    eager -> (graphed, eager, counters, span names, stores)."""
    from pbrt_tpu_torch.core import graphs as cuda_graphs
    from pbrt_tpu_torch.core import probes

    stores = []
    probes.reset()
    probes.enable(True)
    try:
        graphed = _shoots(ro, scene, seeds, stores)
    finally:
        probes.enable(False)
    counters, names = probes.counters(), [s.name for s in probes.spans()]
    probes.reset()
    with monkeypatch.context() as m:
        m.setattr(cuda_graphs, "graphs_for", lambda *a: cuda_graphs.EAGER)
        eager = _shoots(ro, scene, seeds)
    return graphed, eager, counters, names, stores


@pytest.mark.parametrize("name", ["rainbowc", "disp", "benchphoton"])
def test_photon_graphs_match_the_eager_shoot(cuda, tmp_path, monkeypatch, name):
    """Every map (positions, powers, grid), count, shots_full and path
    total bit for bit the eager shoot's, over two frames of two seeds:
    1 + maxphotondepth graphs captured once, none fallen back, every
    batch of both frames replayed (photon/graph spans); every part a
    store kept is as it was when added, after all later replays."""
    ro, scene = _compiled(_photon_text(name), tmp_path, cuda)
    graphed, eager, counters, names, stores = _photon_graphs_vs_eager(ro, scene, monkeypatch)
    for g, e in zip(graphed, eager):
        _maps_equal(g, e)
    depth = graphed[0].max_photon_depth
    batches = sum(c.stats["batches"] for c in graphed)
    assert counters.get("photon/graph_captures", 0) == 1 + depth
    assert counters.get("photon/graph_fallbacks", 0) == 0
    assert [k[0] for k in scene.graphs] == ["photon"]
    assert names.count("photon/batch") == batches
    assert names.count("photon/graph") == batches * (1 + depth)
    assert stores and all(all(torch.equal(a, b) for a, b in zip(part, kept))
                          for part, kept in stores)
    assert sum(c.stats["counts"]["direct"][0] for c in graphed) > 0


def test_photon_graphs_refuse_a_stretch_that_syncs(cuda, tmp_path, monkeypatch):
    """An emission that waits on the card is caught by its warm-up under
    torch's sync debug mode, before any capture: the key falls back once
    and the shoot is the eager one, bit for bit."""
    from pbrt_tpu_torch.photon import shooter

    ro, scene = _compiled(_photon_text("disp"), tmp_path, cuda)
    real = shooter.sample_light_ray

    def syncs(lights, light_idx, *args):
        int(light_idx.max())
        return real(lights, light_idx, *args)

    monkeypatch.setattr(shooter, "sample_light_ray", syncs)
    graphed, eager, counters, names, _ = _photon_graphs_vs_eager(ro, scene, monkeypatch)
    for g, e in zip(graphed, eager):
        _maps_equal(g, e)
    assert counters.get("photon/graph_fallbacks", 0) == 1
    assert counters.get("photon/graph_captures", 0) == 0
    assert "photon/graph" not in names
    assert [k.failed for k in scene.graphs.values()] == [True]


# The photon-volume march in chunks of steps (integrators/photonvolume.py)
# against the step loop of tests/test_torch_march_chunks.py, on the card

def _march_vs_loop(scene, ctx, ray, t_surf, pixel, sidx, n_steps, seed, monkeypatch):
    """The chunked march, counting its K1 launches and chunks, and the
    step loop on the same inputs -> (chunked, loop, launches, chunks)."""
    from pbrt_tpu_torch.core import probes
    from pbrt_tpu_torch.integrators import photonvolume as t_pv
    from pbrt_tpu_torch.ops import intersect_cuda
    from test_torch_march_chunks import step_loop

    launches = [0]
    real = intersect_cuda.tri_t_pass_cuda

    def counted(*args):
        launches[0] += 1
        return real(*args)

    probes.reset()
    steps_a_chunk = t_pv.chunk_steps(ray.o.shape[0], n_steps, ray.o.device)
    with monkeypatch.context() as m:
        m.setattr(intersect_cuda, "tri_t_pass_cuda", counted)
        got = t_pv.li_photonvolume(scene, ctx, ray, t_surf, pixel, sidx, n_steps, seed)
        torch.cuda.synchronize()
    chunks = probes.counters().get("volume/march_chunks", 0)
    probes.reset()
    assert chunks == -(-n_steps // steps_a_chunk)
    ref, _ = step_loop(scene, ctx, ray, t_surf, pixel, sidx, n_steps, seed)
    return got, ref, launches[0], chunks


@pytest.mark.parametrize("name", ["rainbowc", "photon"])
def test_march_chunks_match_the_step_loop(cuda, tmp_path, monkeypatch, name):
    """rainbowc's two tiles of 16,384 lanes (128 steps) over a shoot's
    maps: L and Tr bit for bit the step loop's. PHOTON_SCENE's 256 rays
    (12 steps) over a volume map with live kNN queries: Tr bit for bit,
    L within 1e-6 relative. The kNN's flux, torch.einsum("bks,bk->bs")
    in photon/map.py, is a batched matmul whose rows round differently
    at another batch count on the card (the chunk's 2,818 live queries
    against a step's ~240: up to 3.3e-7 relative, from equal inputs);
    rainbowc's rainbow region masks its lookups. Each chunk `chunk_steps`
    sizes makes one K1 launch (its shadow rays)."""
    from pbrt_tpu_torch.integrators.volume import pick_n_steps
    from pbrt_tpu_torch.photon import shooter
    from pbrt_tpu_torch.renderers import driver
    from test_torch_march_chunks import assert_bitwise, camera_rays, volume_ctx
    from photon_scenes import PHOTON_SCENE

    if name == "photon":
        ro, scene = _compiled(PHOTON_SCENE, tmp_path, cuda)
        ray, _, pixel, sidx = camera_rays(scene, cuda)
        ctx = volume_ctx(device=cuda)
        tiles = [(ray, pixel, sidx)]
        n_steps, seed = 12, 2
    else:
        ro, scene = _compiled(_photon_text("rainbowc"), tmp_path, cuda)
        seed = 2**31 + 7
        ctx = shooter.build_photon_maps(scene, ro.surf_integrator_params,
                                        ro.vol_integrator_params, {"quiet": True, "seed": seed})
        tiles = []
        for t in range(2):   # 8,192 pixels x 2 spp a tile
            ray, pixel, _ = _tile(ro, cuda, t, 8192, seed)
            tiles.append((ray, pixel, torch.arange(2, device=cuda).repeat(8192)))
        n_steps = pick_n_steps(scene.volume, ro.vol_integrator_params.find_one_float(
            "stepsize", 1.0))
        assert n_steps == 128
    for ray, pixel, sidx in tiles:
        t_surf, _ = driver.first_hit_t(scene, ray)
        got, ref, launches, chunks = _march_vs_loop(scene, ctx, ray, t_surf, pixel, sidx,
                                                    n_steps, seed, monkeypatch)
        if name == "rainbowc":
            assert_bitwise(got, ref)
        else:
            assert torch.equal(got.Tr.view(torch.int32), ref.Tr.view(torch.int32))
            torch.testing.assert_close(got.L, ref.L, rtol=1e-6, atol=0.0)
        assert launches == chunks and float(got.L.sum()) > 0
