"""The reader of the path loop's CUDA graph replays
(metrics/path_graph_replays_per_bounce.py): on the CPU, where every
stretch runs eagerly, it reads nothing, and what it would read on a card
is 0; its ratio on synthetic span tables; a program without graphs gives
None. On the card (gpu marker): every stretch of a preview frame
replays, 11 replays over 6 bounces at depth 5."""
import types

import pytest

from perfbench.bench import harness, spans
from test_perf_spans import preview_port, reader, shrunk_run  # noqa: F401 (fixtures)

NAME = "path_graph_replays_per_bounce"


def test_graph_replays_reader_reads_on_a_card_only(shrunk_run):
    from pbrt_tpu_torch.core import probes

    r = reader(NAME)
    assert r.read(shrunk_run) is None
    h = spans.host(shrunk_run)          # replay A on the CPU, cached on the run
    assert h.count("path/bounce") > 0 and h.count("path/graph") == 0
    device, shrunk_run.port.device = shrunk_run.port.device, types.SimpleNamespace(type="cuda")
    try:
        assert r.read(shrunk_run) == 0.0
    finally:
        shrunk_run.port.device = device
    assert not probes.enabled()


def test_graph_replays_ratio_on_synthetic_spans():
    ratio = reader(NAME).ratio
    both = {"render/frame": (1, 2.0, 0.1), "path/bounce": (6, 1.0, 0.5),
            "path/graph": (11, 0.2, 0.2), "path/direct": (5, 0.3, 0.1)}
    assert ratio(spans.HostSpans(1, both)) == pytest.approx(11 / 6)
    eager = {k: v for k, v in both.items() if k != "path/graph"}
    assert ratio(spans.HostSpans(1, eager)) == 0.0
    assert ratio(spans.HostSpans(1, {"render/frame": (1, 2.0, 2.0)})) is None


def test_graph_replays_reader_gives_none_without_path_graphs(monkeypatch):
    from pbrt_tpu_torch.integrators import surface

    monkeypatch.delattr(surface, "PathGraphs")
    run = types.SimpleNamespace(replay=lambda: 1.0,
                                port=types.SimpleNamespace(device=types.SimpleNamespace(type="cuda")))
    assert reader(NAME).read(run) is None


@pytest.mark.gpu
def test_every_stretch_of_a_preview_frame_replays(card, preview_port):
    """One tile a preview frame at depth 5: 11 replays over 6 bounces."""
    port, frame = preview_port
    run = harness.Run(port, {}, None, [frame])
    assert reader(NAME).read(run) == pytest.approx(11 / 6)
