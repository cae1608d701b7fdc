"""quad_fold_share: 100 x the host seconds of the quadric folds (the
program's `accel/quad` spans: each traversal's pass over the scene's
quadrics, in the photon shoot and in the eye pass alike) over the
seconds of `render/frame`, in the traced frames rendered again with the
spans on (bench/spans.py, replay A). None where no quadric was folded,
or the program has no such span."""
from perfbench.bench import spans


def read(run):
    r = spans.host(run)
    if r is None or not r.count("accel/quad"):
        return None
    frame_s = r.seconds(spans.FRAME)
    if frame_s <= 0:
        return None
    return 100.0 * r.seconds("accel/quad") / frame_s
