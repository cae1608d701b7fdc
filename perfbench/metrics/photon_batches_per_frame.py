"""photon_batches_per_frame: the program's `photon/batch` spans (one batch
of photon paths shot, with its one host sync) over its `render/frame`
spans, in the traced frames rendered again with the spans on
(bench/spans.py, replay A). None where no batch was shot."""
from perfbench.bench import spans


def read(run):
    r = spans.host(run)
    if r is None or not r.count("photon/batch"):
        return None
    return r.count("photon/batch") / r.frames
