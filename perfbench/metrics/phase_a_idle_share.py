"""phase_a_idle_share: 100 x the device's idle seconds whose innermost
program span is `accel/phase_a` (the coherence sort, the culls and the
pair compaction of ops/bvh_cuda.py), over every idle second of the
traced frames rendered again with the program's spans on, inside a
profile that records the device alone (bench/spans.py, replay B)."""
from perfbench.bench import spans


def read(run):
    r = spans.idle(run)
    if r is None or r.idle_s <= 0:
        return None
    return r.share("accel/phase_a")
