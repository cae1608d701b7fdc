"""The reader of the photon shoot's CUDA graph replays
(metrics/photon_graph_replays_per_batch.py): on the CPU, where every
stretch runs eagerly, it reads nothing, and what it would read on a card
is 0; its ratio on synthetic span tables; a program without shoot
graphs gives None. On the card (gpu marker): every stretch of a shrunk
`rainbowc.golden96` frame's shoot replays, 6 replays a batch at photon
depth 5."""
import types

import pytest

from perfbench.bench import harness, spans, traffic
from test_rainbow_cell import reader, shrunk_cell

NAME = "photon_graph_replays_per_batch"


def _run(device):
    cell, _ = shrunk_cell()
    port = harness.setup(cell, device)
    frame = next(traffic.frames(cell.traffic, 2**31 + 13))
    port.render(frame)      # the first shoot captures, as set-up's warm-up does
    return port, harness.Run(port, {"compile_s": port.compile_s}, None, [frame])


def test_photon_graph_replays_reader_reads_on_a_card_only():
    from pbrt_tpu_torch.core import probes

    port, run = _run("cpu")
    try:
        r = reader(NAME)
        assert r.read(run) is None
        h = spans.host(run)          # replay A on the CPU, cached on the run
        assert h.count("photon/batch") > 0 and h.count("photon/graph") == 0
        device, port.device = port.device, types.SimpleNamespace(type="cuda")
        try:
            assert r.read(run) == 0.0
        finally:
            port.device = device
        assert not probes.enabled()
    finally:
        port.close()


def test_photon_graph_replays_ratio_on_synthetic_spans():
    ratio = reader(NAME).ratio
    both = {"render/frame": (1, 12.0, 0.1), "photon/batch": (64, 3.0, 1.0),
            "photon/graph": (384, 0.5, 0.5), "photon/build": (1, 0.05, 0.05)}
    assert ratio(spans.HostSpans(1, both)) == pytest.approx(6.0)
    eager = {k: v for k, v in both.items() if k != "photon/graph"}
    assert ratio(spans.HostSpans(1, eager)) == 0.0
    assert ratio(spans.HostSpans(1, {"render/frame": (1, 2.0, 2.0)})) is None


def test_photon_graph_replays_reader_gives_none_without_shoot_graphs(monkeypatch):
    from pbrt_tpu_torch.photon import shooter

    monkeypatch.delattr(shooter, "ShootGraphs")
    run = types.SimpleNamespace(replay=lambda: 1.0,
                                port=types.SimpleNamespace(device=types.SimpleNamespace(type="cuda")))
    assert reader(NAME).read(run) is None


@pytest.mark.gpu
def test_every_stretch_of_a_shoot_replays(card):
    """A shrunk rainbowc frame on the card: 6 replays a batch."""
    port, run = _run(card)
    try:
        assert reader(NAME).read(run) == pytest.approx(6.0)
    finally:
        port.close()
