"""photon_build_share: 100 x the host seconds of the photon shoot (its
`photon/batch` spans: each batch of paths with its one host sync) and of
the map builds (`photon/build`: the kd grids and the radiance
precompute) over the seconds of `render/frame`, in the traced frames
rendered again with the spans on (bench/spans.py, replay A). A program
without `photon/build` gives None."""
from perfbench.bench import spans


def read(run):
    r = spans.host(run)
    if r is None or not r.count("photon/build"):
        return None
    frame_s = r.seconds(spans.FRAME)
    if frame_s <= 0:
        return None
    return 100.0 * (r.seconds("photon/batch") + r.seconds("photon/build")) / frame_s
