"""preview_frame_p90_s: the 90th percentile of the latency of every frame
in the window, from its start until its RGB is on the host."""
from perfbench.bench import stats


def read(window):
    return stats.percentile(window.frame_s, 90)
