"""CPU tests of the port's benchmark (run: python -m pytest perfbench/tests -q).

Tests that need the card carry the `gpu` marker and skip inside the
`card` fixture where there is none."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# a cell cut to a size a CPU test can hold: a 24 x 24 sphere (1,152
# triangles) at 16 x 16 pixels, every pixel of every frame checked
TINY = {"config": {"sphere": {"n_theta": 24, "n_phi": 24, "radius": 1.0,
                              "center": [0.0, 0.4, 0.0], "kd": [0.45, 0.35, 0.65]}},
        "traffic": {"xres": 16, "yres": 16, "tile_samples": 256, "trace_frames": 2,
                    "check": {"frames": 3, "pixels": 256,
                              "limits": None}}}


def tiny(cell: str):
    """TINY with the cell's own check limits."""
    import copy
    import json

    with open(os.path.join(ROOT, "perfbench", "workloads", f"{cell}.json")) as f:
        limits = json.load(f)["check"]["limits"]
    ov = copy.deepcopy(TINY)
    ov["traffic"]["check"]["limits"] = limits
    return ov
