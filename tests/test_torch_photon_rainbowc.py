"""The `rainbowc_const` scene through the port and the JAX package.

`rainbowc_const` is tests/goldens/rainbowc.pbrt with its walls'
imagemap x scale texture replaced by the value it takes where the image
is white, 0.02 (the image file is not in the repo): photonmap with final
gather over a distant light, and photonvolume (5,000 volume photons,
nused 50, 128 march steps) in a rainbow region. Both packages render it
at the same seed on a 24 x 24 crop, in one tile of exactly its samples,
with maxdepth 1: every surface is matte, so no ray continues past depth
0 and the image is the authored one; the cut keeps the JAX package's
CPU compile short.

The exact `rainbowc` (its walls' imagemap x scale texture; the missing
textures/lines.tga reads as one white texel in both packages, as in the
reference) goes through the same comparison.

Limits (the render limits of tests/test_torch_slice.py): the image mean
within 0.5% and at least 99% of pixels within 1e-3 relative.
"""
import numpy as np
import torch

from pbrt_tpu.scene import api as j_api
from pbrt_tpu.scene import parser as j_parser
from pbrt_tpu_torch.scene import api as t_api
from pbrt_tpu_torch.scene import parser as t_parser
from test_torch_goldens import golden_text

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

CROP = (0.375, 0.625, 0.375, 0.625)   # 24 x 24 of 96 x 96


def rainbowc_const_text(crop=None, depth=None):
    """tests/goldens/rainbowc.pbrt with the walls' texture replaced by
    its value where the image is white, 0.02."""
    s = golden_text("rainbowc", crop=crop)
    s = "\n".join(ln for ln in s.splitlines() if not ln.startswith("Texture ")) + "\n"
    s = s.replace('Material "matte" "texture Kd" "sgrid"', 'Material "matte" "rgb Kd" [.02 .02 .02]')
    if depth is not None:
        s = s.replace('SurfaceIntegrator "photonmap"',
                      f'SurfaceIntegrator "photonmap" "integer maxdepth" [{depth}]')
    return s


def render(api, parser, path, tile):
    opts = {"quiet": True, "write": False, "tile_samples": tile}
    if api is t_api:
        opts.update(device="cpu")
    api.pbrt_init(opts)
    try:
        parser.parse_file(str(path))
        return np.asarray(api._state.output)
    finally:
        api._state.__init__()


def _matches_jax(path, text):
    path.write_text(text)
    tile = 24 * 24 * 2
    ref = render(j_api, j_parser, path, tile)
    got = render(t_api, t_parser, path, tile)
    assert got.shape == ref.shape == (24, 24, 3)
    assert np.all(np.isfinite(got)) and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99


def test_rainbowc_matches_jax(tmp_path):
    text = golden_text("rainbowc", crop=CROP).replace(
        'SurfaceIntegrator "photonmap"', 'SurfaceIntegrator "photonmap" "integer maxdepth" [1]')
    assert 'Material "matte" "texture Kd" "sgrid"' in text and "lines.tga" in text
    _matches_jax(tmp_path / "rainbowc.pbrt", text)


def test_rainbowc_const_matches_jax(tmp_path):
    path = tmp_path / "rainbowc_const.pbrt"
    text = rainbowc_const_text(crop=CROP, depth=1)
    assert 'Material "matte" "rgb Kd" [.02 .02 .02]' in text
    assert not any(ln.startswith(("Texture", 'Material "matte" "texture'))
                   for ln in text.splitlines())
    path.write_text(text)
    tile = 24 * 24 * 2
    ref = render(j_api, j_parser, path, tile)
    got = render(t_api, t_parser, path, tile)
    assert got.shape == ref.shape == (24, 24, 3)
    assert np.all(np.isfinite(got)) and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99
