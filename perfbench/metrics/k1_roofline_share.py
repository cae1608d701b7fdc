"""k1_roofline_share: K1's (csrc/intersect.cu) least time on the card over
its device time in the traced frames, in percent.

The device time is the sum of the profiler's rows of K1's three kernels
(`k1_live_kernel`, `k1_sweep_kernel`, `k1_finish_kernel`). The least time
is, per launch, the larger of its Moller-Trumbore operations over the
float32 peak and its bytes over the memory bandwidth
(perfbench/bench/roofline.py k1_launch_bound: the live rays, tmin < tmax,
each against every real triangle), counted from each call of
`ops.intersect_cuda.tri_t_pass` while the same frames render again
untraced: their rays are the traced frames' own."""
import re

from perfbench.bench import roofline

K1_ROW = re.compile(r"k1_(live|sweep|finish)_kernel")


class _Recorder:
    def __init__(self, t_pass):
        self.t_pass, self.works = t_pass, []

    def __call__(self, soa, ray_o, ray_d, tmin, tmax):
        out = self.t_pass(soa, ray_o, ray_d, tmin, tmax)
        self.works.append((ray_o.shape[0], (tmin < tmax).sum(), soa.n))
        return out

    def rows(self):
        return [(rays, int(live.item()), n) for rays, live, n in self.works]


def read(run):
    t = run.trace
    if t is None:
        return None
    k1_s = sum(s for name, (s, _) in t.by_name.items() if K1_ROW.search(name))
    if k1_s <= 0:
        return None
    from pbrt_tpu_torch.ops import intersect_cuda

    rec = _Recorder(intersect_cuda.tri_t_pass)
    intersect_cuda.tri_t_pass = rec
    try:
        run.replay()
    finally:
        intersect_cuda.tri_t_pass = rec.t_pass
    rows = rec.rows()
    if not rows:
        return None
    return 100.0 * sum(max(roofline.k1_launch_bound(*r)) for r in rows) / k1_s
