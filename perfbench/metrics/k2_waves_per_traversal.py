"""k2_waves_per_traversal: the program's `accel/k2` spans (one K2 launch
per wave of the packet traversal) over its `accel/traverse` spans (one
wide_t_pass call), in the traced frames rendered again with the spans
on (bench/spans.py, replay A)."""
from perfbench.bench import spans


def read(run):
    r = spans.host(run)
    if r is None or not r.count("accel/traverse"):
        return None
    return r.count("accel/k2") / r.count("accel/traverse")
