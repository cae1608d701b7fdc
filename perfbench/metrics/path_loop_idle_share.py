"""path_loop_idle_share: 100 x the device's idle seconds whose innermost
program span is the path loop's own (`path/bounce`, `path/direct`,
`render/tile`: shading, light sampling, camera samples and the film
deposit, the traversals they call excluded), over every idle second of
the traced frames in replay B (bench/spans.py)."""
from perfbench.bench import spans


def read(run):
    r = spans.idle(run)
    if r is None or r.idle_s <= 0:
        return None
    return r.share("path/bounce", "path/direct", "render/tile")
