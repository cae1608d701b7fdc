"""Multi-device rendering over a torch.distributed process group.

Port of pbrt_tpu/parallel/mesh.py (the replacement of the reference's
pthread pool, core/parallel.cpp:722-879). The JAX package shards one
program over a device mesh; here each rank is a process with one
device (NCCL between cards, gloo on the CPU), and the same three merges
are explicit collectives:

- render tiles    -> each rank renders its contiguous slice of every
                     tile's pixels (`shard_batch`) into its own film
                     accumulators (the SamplerRendererTask fan-out,
                     samplerrenderer.cpp:205-217);
- photon batches  -> each rank traces its slice of a batch's lanes and
                     `gather_replicated` all-gathers the records in
                     rank order, so every rank holds the whole batch
                     (the photon-merge mutex, photonshooter.cpp:280);
- film            -> `reduce_sum` all-reduces the accumulators before
                     the image or a checkpoint is written (the film's
                     atomic adds, image.cpp:130).

The samplers and the shooter draw their numbers per (pixel, sample) and
per lane, so a sharded render differs from an unsharded one only in the
order the film reduction sums the ranks' deposits, and the photon maps
are identical. Every collective is counted in the probes counters
("mesh/collectives", "mesh/collective_us": microseconds of host wall,
the device synchronised after each one).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.distributed as dist

from pbrt_tpu_torch.core import probes


@dataclass(frozen=True)
class Mesh:
    """This process's place in the render group."""

    rank: int
    world: int
    device: torch.device
    backend: str


def mesh_from_options(options: Optional[dict] = None) -> Optional[Mesh]:
    """The render group of this process: None unless a process group was
    initialized (the CLI's --ncores > 1 or --distributed), in which case
    every render and photon shoot shards over it, also at world size 1."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    options = options or {}
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
                device=torch.device(options.get("device", "cuda")),
                backend=dist.get_backend())


def round_to_world(mesh: Optional[Mesh], n: int) -> int:
    """n rounded down to a multiple of the world size (at least one per
    rank), as the JAX package rounds tiles and batches to its mesh."""
    if mesh is None:
        return n
    return max(mesh.world, (n // mesh.world) * mesh.world)


def shard_batch(mesh: Mesh, arr):
    """This rank's contiguous slice of the leading axis of a batch that is
    identical on every rank (its length a multiple of the world size)."""
    per = arr.shape[0] // mesh.world
    return arr[mesh.rank * per:(mesh.rank + 1) * per]


class _Timed:
    """Counts one collective and its host wall (device synchronised)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        probes.count("mesh/collectives")
        probes.count("mesh/collective_us", round((time.perf_counter() - self.t0) * 1e6))


def _wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The tensor as the backend can carry it: gloo is a host transport,
    so with gloo a card tensor goes to the host for the collective (and
    back after it; the rest of the render stays on the card). Bools
    travel as uint8."""
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    if mesh.backend == "gloo":
        t = t.cpu()
    return t.contiguous()


def gather_replicated(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """All-gather each rank's batch slice along the leading axis, in rank
    order: every rank ends up holding the whole batch."""
    out = []
    with _Timed(mesh):
        for t in tensors:
            w = _wire(mesh, t)
            parts = [torch.empty_like(w) for _ in range(mesh.world)]
            dist.all_gather(parts, w)
            out.append(torch.cat(parts).to(device=t.device, dtype=t.dtype))
    return out


def reduce_sum(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum all-reduce of each tensor over the ranks (the film
    reduction); returns new tensors, the inputs are left as they are."""
    out = []
    with _Timed(mesh):
        for t in tensors:
            w = _wire(mesh, t)
            w = w.clone() if w is t else w
            dist.all_reduce(w, op=dist.ReduceOp.SUM)
            out.append(w.to(device=t.device, dtype=t.dtype))
    return out
