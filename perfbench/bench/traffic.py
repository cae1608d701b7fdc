"""The frame generator: one general reader of a cell's traffic file.

A cell's frames are a closed loop (one user waits for each frame). Frame
i has a seed and a camera pose, both drawn from --seed. The traffic
file's `camera` says where the poses come from:

- {"motion": "orbit", "radius", "height", "look", "up", "views"}: `views`
  points on a circle about the look-at point's vertical axis (view 0 at
  (look.x, height, look.z - radius));
- {"motion": "poses", "poses": [[eye, look, up], ...]}: the poses listed;
- {"motion": "fixed"} (or no `camera`): the scene's own camera, pose None.

Every seed renders the same set of views, in an order that the seed
permutes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class Frame:
    index: int
    seed: int
    eye: Optional[tuple]      # None: the scene's own camera
    look: Optional[tuple]
    up: Optional[tuple]


def _rng(seed: int, stream: int):
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def orbit_pose(orbit: dict, k: int):
    """Pose of view k of the orbit: angle 0 is (0, height, -radius) about
    the look-at point's vertical axis."""
    a = 2.0 * math.pi * k / orbit["views"]
    look = orbit["look"]
    eye = (look[0] + orbit["radius"] * math.sin(a), orbit["height"],
           look[2] - orbit["radius"] * math.cos(a))
    return eye, tuple(look), tuple(orbit["up"])


def views(traffic: dict) -> list:
    """The cell's camera poses, (eye, look, up) or (None, None, None)."""
    cam = traffic.get("camera", {"motion": "fixed"})
    motion = cam["motion"]
    if motion == "orbit":
        return [orbit_pose(cam, k) for k in range(int(cam["views"]))]
    if motion == "poses":
        return [tuple(tuple(float(x) for x in v) for v in p) for p in cam["poses"]]
    if motion == "fixed":
        return [(None, None, None)]
    raise ValueError(f"unknown camera motion {motion!r}")


def frames(traffic: dict, seed: int) -> Iterator[Frame]:
    """Frames 0, 1, 2, ... of the run with this seed."""
    poses = views(traffic)
    rng = _rng(seed, 0)
    order = rng.permutation(len(poses))
    i = 0
    while True:
        eye, look, up = poses[int(order[i % len(order)])]
        yield Frame(i, int(rng.integers(0, 1 << 31)), eye, look, up)
        i += 1


def warmup_frame(traffic: dict) -> Frame:
    """The set-up's frame: the same shapes as every timed frame."""
    eye, look, up = views(traffic)[0]
    return Frame(-1, 1, eye, look, up)


def choose(seed: int, n_frames: int, k_frames: int, xres: int, yres: int, k_pixels: int):
    """The check's sample, drawn from the seed: up to k_frames of the
    n_frames frames, and k_pixels distinct pixels of each ->
    (frame indices [F], x [F, P], y [F, P])."""
    rng = _rng(seed, 1)
    fr = np.sort(rng.choice(n_frames, size=min(k_frames, n_frames), replace=False))
    k = min(k_pixels, xres * yres)
    pix = np.stack([rng.choice(xres * yres, size=k, replace=False) for _ in fr])
    return fr, pix % xres, pix // xres
