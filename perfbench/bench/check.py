"""The comparison that decides `correct`.

After the window has closed and the renderer's scene is freed, the plain
reference renders a sample of the pixels of the frames the window
produced, drawn from the seed, and each pixel of the renderer's RGB is
held against the reference's. Two numbers are read:

- `bad_pixel_pct`: the percentage of checked pixels whose largest
  channel differs from the reference's by more than 1e-3 of the
  reference's value (1e-6 at the least);
- `mean_rel_diff`: the relative difference of the two means over the
  checked pixels.

Each is held to the limit the cell's traffic file gives it. A path that
meets a tie (an edge shared by two triangles, a grazing shadow ray)
may take another branch in the two programs, so a few pixels differ by
nature; a lower precision moves nearly all of them.
"""
from __future__ import annotations

import numpy as np

PIXEL_RTOL = 1e-3


def compare(prog: np.ndarray, ref: np.ndarray) -> dict:
    prog = np.asarray(prog, np.float64).reshape(-1, 3)
    ref = np.asarray(ref, np.float64).reshape(-1, 3)
    rel = (np.abs(prog - ref) / np.maximum(np.abs(ref), 1e-6)).max(-1)
    bad = ~(rel <= PIXEL_RTOL)                     # NaN counts as bad
    mean_ref = ref.mean()
    return {"bad_pixel_pct": 100.0 * float(bad.mean()),
            "mean_rel_diff": float(abs(prog.mean() - mean_ref) / max(abs(mean_ref), 1e-30))}


def judge(numbers: dict, limits: dict):
    """-> (correct, [(name, value, limit)]) over the numbers that have a
    limit; a number that is NaN fails."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
