"""samples_per_s: camera samples (pixels x spp) of every frame the window
completed, over the time from the first frame's start to the last
frame's end (host clock; a frame ends when its RGB is on the host)."""
from perfbench.bench import stats


def read(window):
    return stats.rate(window.samples, window.t_first, window.t_end)
