"""End-to-end statistics over a window's frames."""
from __future__ import annotations

import numpy as np


def rate(samples: int, t_first_start: float, t_last_end: float) -> float:
    """Work of every frame completed, over the time from the first frame's
    start to the last frame's end."""
    return samples / (t_last_end - t_first_start)


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (linear between order statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), q))
