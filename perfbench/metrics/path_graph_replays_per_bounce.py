"""path_graph_replays_per_bounce: the program's `path/graph` spans (one
CUDA graph replay of a shading stretch of the path loop) over its
`path/bounce` spans (one depth of the path loop), in the traced frames
rendered again with the spans on (bench/spans.py, replay A). At depth
d the loop has 2 d + 1 stretches over d + 1 bounces: 11 / 6 at depth 5
when every stretch replays, 0 when every one runs eagerly (a capture
failed). On the card only: the CPU has no graphs. A program whose path
loop has none (no `PathGraphs` in pbrt_tpu_torch.integrators.surface)
gives None."""
from perfbench.bench import spans


def ratio(host):
    """HostSpans -> path/graph spans over path/bounce spans, or None
    where no bounce ran."""
    bounces = host.table.get("path/bounce", (0, 0.0, 0.0))[0]
    if not bounces:
        return None
    return host.table.get("path/graph", (0, 0.0, 0.0))[0] / bounces


def has_graphs() -> bool:
    try:
        from pbrt_tpu_torch.integrators import surface
    except ImportError:
        return False
    return hasattr(surface, "PathGraphs")


def read(run):
    if not (spans.on_card(run) and has_graphs()):
        return None
    r = spans.host(run)
    return None if r is None else ratio(r)
