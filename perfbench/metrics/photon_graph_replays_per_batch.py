"""photon_graph_replays_per_batch: the program's `photon/graph` spans (one
CUDA graph replay of a stretch of the photon shoot's batch) over its
`photon/batch` spans (one batch of photon paths, with its one host
sync), in the traced frames rendered again with the spans on
(bench/spans.py, replay A). A batch of max photon depth D has 1 + D
stretches, the emission and one a depth: 6 at depth 5 when every
stretch replays, 0 when every one runs eagerly (a capture failed). On
the card only: the CPU has no graphs. A program whose shoot has none (no
`ShootGraphs` in pbrt_tpu_torch.photon.shooter) gives None, and so does a
run that shot no batch."""
from perfbench.bench import spans


def ratio(host):
    """HostSpans -> photon/graph spans over photon/batch spans, or None
    where no batch was shot."""
    batches = host.table.get("photon/batch", (0, 0.0, 0.0))[0]
    if not batches:
        return None
    return host.table.get("photon/graph", (0, 0.0, 0.0))[0] / batches


def has_graphs() -> bool:
    try:
        from pbrt_tpu_torch.photon import shooter
    except ImportError:
        return False
    return hasattr(shooter, "ShootGraphs")


def read(run):
    if not (spans.on_card(run) and has_graphs()):
        return None
    r = spans.host(run)
    return None if r is None else ratio(r)
