"""The seam of the CUDA-graph stretches (core/graphs.py) over both of its
owners, the path loop (integrators/surface.py PathGraphs) and the photon
shoot (photon/shooter.py ShootGraphs), on the CPU: the one rule for
where stretches replay (a card lane, no autograd, the scene's table, a
key that has not fallen back; for the path loop also no medium), and a
key whose capture raises, which falls back for good, counted once, with
the eager result bit for bit. The graphs themselves run on the card:
tests/test_torch_gpu.py holds them bit for bit against the eager
stretches.
"""
import dataclasses

import pytest
import torch

from pbrt_tpu_torch import diff
from pbrt_tpu_torch.core import graphs as cuda_graphs
from pbrt_tpu_torch.core import spectrum as spec
from pbrt_tpu_torch.integrators import surface
from pbrt_tpu_torch.photon import shooter
from test_torch_path_graphs import compiled  # noqa: F401 (fixture)
from test_torch_photon_graphs import (_build, _card_lane, _maps_equal, _traced,  # noqa: F401
                                      small_shoot)

torch.set_num_threads(1)  # small tensors: intra-op threads only contend with the other test workers

OWNERS = {"path": (surface.PathGraphs, (256, 3, 3)),
          "photon": (shooter.ShootGraphs, (4096, 5, True))}
CASES = [(owner, case) for owner in OWNERS
         for case in ("card", "off_card", "autograd", "no_table", "fallen")] + [("path", "medium")]


def _faking_a_card(monkeypatch):
    """Makes the rule see every owner's lanes on a card -> the keys it
    was asked for."""
    asked = []
    real = cuda_graphs.graphs_for

    def on_a_card(scene, cls, lanes, key):
        asked.append(key)
        return real(scene, cls, _card_lane(lanes.shape[0]), key)

    monkeypatch.setattr(cuda_graphs, "graphs_for", on_a_card)
    return asked


@pytest.mark.parametrize("owner, case", CASES)
def test_graphs_replay_only_where_the_rule_allows(compiled, monkeypatch, owner, case):  # noqa: F811
    """graphs_for gives the owner's graph set for its key, kept in the
    scene's table, on a card lane without autograd; EAGER off a card,
    under autograd (the same scene gets its graphs under no_grad), on a
    scene object without the table and for a key that fell back. li_path
    with a medium never asks."""
    cls, key = OWNERS[owner]
    scene = dataclasses.replace(compiled[0])      # a copy, with a table of its own
    full_key = (cls.name,) + key
    card = _card_lane(key[0])
    if case == "medium":
        _, ray, pixel, sidx = compiled
        asked = _faking_a_card(monkeypatch)
        medium = lambda p, wi, d: torch.full((p.shape[0], spec.N_BINS), 0.5)  # noqa: E731
        L, names, counters = _traced(lambda: surface.li_path(scene, ray, pixel, sidx, 3, seed=4,
                                                             transmittance_fn=medium))
        assert float(L.sum()) > 0 and asked == [] and not scene.graphs
        assert "path/graph" not in names and not counters
        return
    if case == "card":
        g = cuda_graphs.graphs_for(scene, cls, card, key)
        assert type(g) is cls and scene.graphs == {full_key: g} and not g.graphs
        assert g.name == owner and cuda_graphs.graphs_for(scene, cls, card, key) is g
        return
    if case == "off_card":
        assert cuda_graphs.graphs_for(scene, cls, torch.arange(key[0]), key) is cuda_graphs.EAGER
        assert not scene.graphs
    elif case == "autograd":
        params = diff.default_params(scene, want=("kd_scale",))
        scene = diff.apply_params(scene, params._replace(kd_scale=params.kd_scale.requires_grad_()))
        assert cuda_graphs.graphs_for(scene, cls, card, key) is cuda_graphs.EAGER
        assert not scene.graphs
        with torch.no_grad():
            g = cuda_graphs.graphs_for(scene, cls, card, key)
        assert type(g) is cls and list(scene.graphs) == [full_key]
    elif case == "no_table":
        assert cuda_graphs.graphs_for(object(), cls, card, key) is cuda_graphs.EAGER
    else:   # a key that fell back
        scene.graphs[full_key] = fallen = cls("cuda:0")
        fallen.failed = True
        assert cuda_graphs.graphs_for(scene, cls, card, key) is cuda_graphs.EAGER
        assert scene.graphs == {full_key: fallen}


@pytest.mark.parametrize("owner", ["path", "photon"])
def test_a_key_that_fell_back_stays_eager(compiled, small_shoot, monkeypatch,  # noqa: F811
                                          owner):
    """A stretch whose capture raises (here: the first, the path loop's
    stretch A of depth 0 or the shoot's emission) leaves its key eager
    for good: one <name>/graph_fallbacks and a warning, no capture, no
    replay, the key marked failed (the rule then gives EAGER), and the
    image or every map, count and path total bit for bit the eager
    run's, through the static buffers."""
    if owner == "path":
        scene, ray, pixel, sidx = compiled
        scene = dataclasses.replace(scene)

        def run():
            return surface.li_path(scene, ray, pixel, sidx, 3, seed=4)
        first = "('a', 0)"
    else:
        ro, scene = small_shoot
        scene = dataclasses.replace(scene)

        def run():
            return _build(ro, scene)
        first = "emit"
    eager = run()
    tries = []

    def refuses(self, fn):
        tries.append(1)
        raise RuntimeError("refused inside a capture")

    asked = _faking_a_card(monkeypatch)
    monkeypatch.setattr(cuda_graphs.StretchGraphs, "_capture", refuses)
    warned = []
    monkeypatch.setattr(cuda_graphs, "warning", warned.append)
    got, names, counters = _traced(run)
    if owner == "path":
        assert torch.equal(got.view(torch.int32), eager.view(torch.int32))
    else:
        _maps_equal(got, eager)
        assert names.count("photon/batch") == 2
    assert counters.get(f"{owner}/graph_fallbacks", 0) == 1 and tries == [1]
    assert counters.get(f"{owner}/graph_captures", 0) == 0
    assert f"{owner}/graph" not in names
    (key, graphs), = scene.graphs.items()
    assert key[0] == owner and graphs.failed and not graphs.graphs and graphs.bufs
    assert len(warned) == 1 and f"stretch {first} stays eager" in warned[0]
    assert cuda_graphs.graphs_for(scene, type(graphs), torch.arange(key[1]),
                                  key[1:]) is cuda_graphs.EAGER
    assert asked == [key[1:], key[1:]]
