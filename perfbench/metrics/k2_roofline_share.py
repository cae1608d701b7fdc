"""k2_roofline_share: K2's (csrc/bvh_sweep.cu) least time on the card over
its device time in the traced frames, in percent.

The device time is the sum of the profiler's rows whose kernel name holds
`k2_` (the sweep, items and merge kernels of one launch). The least time
is, per launch, the larger of its Moller-Trumbore operations over the
float32 peak and its bytes over the memory bandwidth (perfbench/bench/
roofline.py), counted from each launch's pair list while the same frames
render again untraced: their pair lists are the traced frames' own."""
from perfbench.bench import roofline


class _Recorder:
    def __init__(self, sweep):
        self.sweep, self.works = sweep, []

    def __call__(self, pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc):
        out = self.sweep(pair_block, start, count, rays8, tris16, sentinel, t_acc, p_acc)
        self.works.append(roofline.k2_work(pair_block, start, count, sentinel))
        return out

    def rows(self):
        return [[int(x) for x in dev.tolist()] + [n_tiles] for dev, n_tiles in self.works]


def read(run):
    t = run.trace
    if t is None:
        return None
    k2_s = sum(s for name, (s, _) in t.by_name.items() if "k2_" in name)
    if k2_s <= 0:
        return None
    from pbrt_tpu_torch.ops import bvh_cuda

    rec = _Recorder(bvh_cuda.wide_sweep)
    bvh_cuda.wide_sweep = rec
    try:
        run.replay()
    finally:
        bvh_cuda.wide_sweep = rec.sweep
    rows = rec.rows()
    if not rows:
        return None
    return 100.0 * sum(max(roofline.k2_launch_bound(*r)) for r in rows) / k2_s
