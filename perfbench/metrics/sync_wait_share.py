"""sync_wait_share: 100 x the host seconds inside the program's `sync/*`
spans (each wraps one call that waits on the card), over the seconds of
its `render/frame` spans, in the traced frames rendered again with the
spans on and no profiler (bench/spans.py, replay A). On the card only:
a CPU run waits on nothing."""
from perfbench.bench import spans


def read(run):
    if not spans.on_card(run):
        return None
    r = spans.host(run)
    if r is None or r.seconds(spans.FRAME) <= 0:
        return None
    return 100.0 * r.seconds("sync/") / r.seconds(spans.FRAME)
