"""photon_lookup_share: 100 x the host seconds of the surface photon-map
lookups (the program's `photon/lookup` spans: each caustic or indirect
density estimate with its kNN and its one host sync) over the seconds of
`render/frame`, in the traced frames rendered again with the spans on
(bench/spans.py, replay A). None where no lookup ran, or the program has
no such span."""
from perfbench.bench import spans


def read(run):
    r = spans.host(run)
    if r is None or not r.count("photon/lookup"):
        return None
    frame_s = r.seconds(spans.FRAME)
    if frame_s <= 0:
        return None
    return 100.0 * r.seconds("photon/lookup") / frame_s
