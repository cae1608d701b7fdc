"""A whole metropolis render of the port against the JAX package's.

The slice scene at 8 x 8 through Renderer "metropolis" (one step of the
4,096 chains: 64 mutations a pixel; a 4,096-path bootstrap; maxdepth 2,
bidirectional; no separate direct pass, whose jitted compile would
double this file's time) in both packages, each package's path
evaluations recorded: the bootstrap's, the chains' start and the step's.
Checks: the bootstrap draws and the chains resampled by choice are
equal bit for bit; the proposals u_prop equal too except in a few small
steps, whose jitter b * exp(-log(b / a) * eps) goes through exp, which
XLA and ATen round apart by an ulp (there u_prop within 2e-9, an ulp
of the jitter's largest magnitude 1/64, plus an ulp of u from the
rounded sum: 0.2% of the coordinates here); the path contributions agree within 1e-5
of the largest; each chain's acceptance probability within 1e-5 relative; an
accept decision may differ only where the acceptance draw lies within
1e-5 of the acceptance probability (those lanes counted); with none
differing, the images agree to the whole-slice limits (mean within
0.5%, 99% of pixels within 1e-3 relative; observed 2e-7).
"""
import os
import sys

import numpy as np
import jax
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_slice import _render, scene_text  # noqa: E402

from pbrt_tpu.integrators import bidir as j_bidir  # noqa: E402
from pbrt_tpu.scene import api as j_api  # noqa: E402
from pbrt_tpu.scene import parser as j_parser  # noqa: E402
from pbrt_tpu_torch.core import threefry  # noqa: E402
from pbrt_tpu_torch.integrators import bidir as t_bidir  # noqa: E402
from pbrt_tpu_torch.renderers import metropolis  # noqa: E402
from pbrt_tpu_torch.scene import api as t_api  # noqa: E402
from pbrt_tpu_torch.scene import parser as t_parser  # noqa: E402

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

RENDERER = ('Renderer "metropolis" "integer samplesperpixel" [64] '
            '"integer bootstrapsamples" [4096] "integer maxdepth" [2] '
            '"bool dodirectseparately" ["false"]\n')


def _luminance(L):
    from pbrt_tpu_torch.core import spectrum

    return spectrum.y(torch.as_tensor(L)).numpy()


def test_metropolis_render_matches_jax(tmp_path, monkeypatch):
    text = scene_text(res=8, spp=1, depth=2).replace(
        'Sampler "lowdiscrepancy" "integer pixelsamples" [1]\n', RENDERER)
    path = tmp_path / "mlt.pbrt"
    path.write_text(text)
    calls = {"jax": [], "port": []}
    j_path_l, t_path_l = j_bidir.path_l_psamples, t_bidir.path_l_psamples

    def j_record(*args, **kw):
        px, py, L = j_path_l(*args, **kw)
        jax.debug.callback(lambda *a: calls["jax"].append([np.asarray(x) for x in a]),
                           args[3], px, py, L)
        return px, py, L

    def t_record(*args, **kw):
        px, py, L = t_path_l(*args, **kw)
        calls["port"].append([x.numpy().copy() for x in (args[3], px, py, L)])
        return px, py, L

    monkeypatch.setattr(j_bidir, "path_l_psamples", j_record)
    monkeypatch.setattr(t_bidir, "path_l_psamples", t_record)
    ref = _render(j_api, j_parser, path)
    got = _render(t_api, t_parser, path)
    assert [len(calls[k]) for k in ("jax", "port")] == [3, 3]   # bootstrap, start, one step
    st = metropolis.last_stats
    assert (st["steps"], st["chains"], st["bootstrap_paths"]) == (1, 4096, 4096)

    scale = max(np.abs(c[3]).max() for c in calls["jax"])
    for k, ((ju, jpx, jpy, jL), (tu, tpx, tpy, tL)) in enumerate(zip(calls["jax"],
                                                                    calls["port"])):
        if k < 2:   # the bootstrap draws and the resampled chains: bit for bit
            np.testing.assert_array_equal(tu.view(np.int32), ju.view(np.int32))
            np.testing.assert_array_equal(tpx, jpx)
            np.testing.assert_array_equal(tpy, jpy)
        else:       # u_prop: the small step's exp rounds apart in XLA and ATen
            apart = tu != ju
            assert apart.mean() < 0.01
            np.testing.assert_allclose(tu, ju, rtol=1.2e-7, atol=2e-9)
            np.testing.assert_allclose(tpx, jpx, rtol=1.2e-7, atol=2e-8)
            np.testing.assert_allclose(tpy, jpy, rtol=1.2e-7, atol=2e-8)
        np.testing.assert_allclose(tL, jL, rtol=1e-5, atol=1e-5 * scale)

    # the step's acceptance: each package's own luminances, the shared draw
    key = threefry.split(threefry.split(threefry.split(threefry.prng_key(0))[0])[0])[1]
    draw = threefry.uniform(threefry.fold_in(key, 7), (4096,), "cpu").numpy()
    acc, a_p = {}, {}
    for who in ("jax", "port"):
        y_cur = np.maximum(_luminance(calls[who][1][3]), 1e-12)
        y_p = _luminance(calls[who][2][3])
        a_p[who] = np.clip(y_p / np.maximum(y_cur, 1e-12), 0.0, 1.0)
        acc[who] = draw < a_p[who]
    np.testing.assert_allclose(a_p["port"], a_p["jax"], rtol=1e-5, atol=1e-7)
    flipped = acc["port"] != acc["jax"]
    assert np.all(np.abs(draw[flipped] - a_p["jax"][flipped]) < 1e-5)
    assert 500 < acc["jax"].sum() < 4000 and int(flipped.sum()) == 0

    assert ref.shape == got.shape == (8, 8, 3) and ref.mean() > 0
    assert abs(got.mean() - ref.mean()) <= 5e-3 * ref.mean()
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    assert (rel <= 1e-3).mean() >= 0.99
