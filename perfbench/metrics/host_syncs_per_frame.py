"""host_syncs_per_frame: the program's `sync/*` spans (each one call
that waits on the card) per `render/frame` span, in the traced frames
rendered again with the spans on (bench/spans.py, replay A). On the
card only: a CPU run waits on nothing."""
from perfbench.bench import spans


def read(run):
    if not spans.on_card(run):
        return None
    r = spans.host(run)
    if r is None:
        return None
    return r.count("sync/") / r.frames
