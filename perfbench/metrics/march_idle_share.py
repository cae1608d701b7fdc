"""march_idle_share: 100 x the device's idle seconds whose innermost program
span is the volume march's own (a name that starts with `volume/`: the
march, its steps, the transmittance toward the light), over every idle
second of the traced frames in replay B (bench/spans.py). The waits of
the kNN inside a march (`sync/knn_live`) are not the march's: their
innermost span is the sync's. A program without the `volume/march` span
gives None."""
from perfbench.bench import spans


def read(run):
    r = spans.idle(run)
    if r is None or r.idle_s <= 0 or not any(s.name == "volume/march" for s in r.spans):
        return None
    return r.share(*(name for name in r.by_span if name.startswith("volume/")))
