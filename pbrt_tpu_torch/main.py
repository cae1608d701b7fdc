"""CLI: python -m pbrt_tpu_torch.main [options] <scene.pbrt ...>

Port of pbrt_tpu/main.py (reference main/pbrt.cpp:41-81): flag parsing,
pbrtInit -> ParseFile per scene -> pbrtCleanup. Renders on the GPU by
default; fails when no CUDA device is present. `--device cpu` renders
with the plain torch versions of the kernels.

Multi-device rendering (parallel/mesh.py) runs one process per device
in a torch.distributed group:
  --ncores N     spawns min(N, cards) ranks on this host, one a card (N
                 gloo ranks with --device cpu); rank 0 writes the image;
  --distributed  joins a group as one rank: PBRT_COORDINATOR (host:port),
                 PBRT_NUM_PROCESSES and PBRT_PROCESS_ID name it, as for
                 the JAX package, else torchrun's env:// variables; each
                 process writes its own --outfile.
Cards talk over NCCL; when the group has more ranks than this host has
cards, ranks share cards, which NCCL cannot do, and the group uses gloo
(tensors go through the host for each collective). A failed rendezvous
or collective fails the run.
"""
from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys

GROUP_TIMEOUT_S = 600   # rendezvous and collectives: a lost rank fails the run


def _parser():
    ap = argparse.ArgumentParser(prog="pbrt_tpu_torch")
    ap.add_argument("scenes", nargs="*", help=".pbrt scene files")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--outfile", default="", help="output image path")
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution / one sample per pixel for fast iteration")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="record spans; print the counters and spans at WorldEnd")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="film checkpoint file (npz) for crash-resumable renders")
    ap.add_argument("--tile-samples", type=int, default=0,
                    help="camera samples per wavefront tile (0 = 65536; 16384 for "
                         "the photon integrators)")
    ap.add_argument("--ncores", type=int, default=1,
                    help="ranks to spawn on this host, one per card (per CPU rank with "
                         "--device cpu); 1 renders in this process, unsharded")
    ap.add_argument("--distributed", action="store_true",
                    help="join a torch.distributed group as one rank (PBRT_COORDINATOR, "
                         "PBRT_NUM_PROCESSES, PBRT_PROCESS_ID, else env://)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("pbrt_tpu_torch: no CUDA device available (use --device cpu to render "
              "on the CPU)", file=sys.stderr)
        return 1
    if not args.scenes:
        print("pbrt_tpu_torch: reading scene from stdin is not supported; "
              "pass a scene file", file=sys.stderr)
        return 1
    if args.distributed and args.ncores > 1:
        print("pbrt_tpu_torch: --ncores spawns its own group; with --distributed, start "
              "one process per rank", file=sys.stderr)
        return 1
    if args.distributed:
        env = os.environ
        if env.get("PBRT_COORDINATOR"):
            keys = ("PBRT_NUM_PROCESSES", "PBRT_PROCESS_ID")
            init = f"tcp://{env['PBRT_COORDINATOR']}"
        else:   # torchrun
            keys, init = ("WORLD_SIZE", "RANK"), "env://"
        if not all(k in env for k in keys):
            print(f"pbrt_tpu_torch: --distributed needs {' and '.join(keys)} (with "
                  "PBRT_COORDINATOR, or torchrun's MASTER_ADDR / MASTER_PORT)",
                  file=sys.stderr)
            return 1
        world, rank = (int(env[k]) for k in keys)
        return _rank_main(rank, world, init, args, int(env.get("LOCAL_RANK", rank)))
    if args.ncores > 1:
        return _spawn(args)
    return _render(args, args.device, write=True)


def _render(args, device: str, write: bool) -> int:
    from pbrt_tpu_torch.core.error import PbrtError
    from pbrt_tpu_torch.scene import api, parser

    api.pbrt_init({
        "device": device,
        "imageFile": args.outfile,
        "quick": args.quick,
        "quiet": args.quiet,
        "verbose": args.verbose,
        "seed": args.seed,
        "checkpoint": args.checkpoint or None,
        "tile_samples": args.tile_samples,
        "write": write,
    })
    try:
        for fn in args.scenes:
            try:
                parser.parse_file(fn)
            except FileNotFoundError:
                print(f"pbrt_tpu_torch: couldn't open scene file \"{fn}\"", file=sys.stderr)
                return 1
            except PbrtError as e:
                print(f"pbrt_tpu_torch: {fn}: {e}", file=sys.stderr)
                return 1
        try:
            api.pbrt_cleanup()   # a scene left inside its world block fails here
        except PbrtError as e:
            print(f"pbrt_tpu_torch: {e}", file=sys.stderr)
            return 1
    finally:
        api._state.__init__()
    return 0


def _rank_main(rank: int, world: int, init: str, args, local_rank: int,
               write: bool = True) -> int:
    """One rank: join the group, render on this rank's device, leave."""
    import torch
    import torch.distributed as dist

    device = args.device
    backend = "gloo"
    if device.startswith("cuda"):
        n_cards = torch.cuda.device_count()
        device = f"cuda:{local_rank % n_cards}"
        torch.cuda.set_device(device)
        if world <= n_cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        return _render(args, device, write)
    finally:
        dist.destroy_process_group()


def _spawned_rank(rank: int, world: int, init: str, args):
    """Entry of a rank spawned by --ncores (rank 0 writes the image)."""
    rc = _rank_main(rank, world, init, args, rank, write=rank == 0)
    if rc:
        sys.exit(rc)


def _spawn(args) -> int:
    """--ncores N: N ranks on this host, one per card (at most the count of
    cards), joined over a free local port."""
    import torch
    import torch.multiprocessing as mp

    world = args.ncores
    if args.device.startswith("cuda"):
        world = min(world, torch.cuda.device_count())
    if world <= 1:
        return _render(args, args.device, write=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        mp.start_processes(_spawned_rank, args=(world, f"tcp://127.0.0.1:{port}", args),
                           nprocs=world, join=True, start_method="spawn")
    except mp.ProcessException as e:
        print(f"pbrt_tpu_torch: a rank failed: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
