"""CLI: python -m pbrt_tpu_torch.main [options] <scene.pbrt ...>

Port of pbrt_tpu/main.py (reference main/pbrt.cpp:41-81): flag parsing,
pbrtInit -> ParseFile per scene -> pbrtCleanup. Renders on the GPU by
default; fails when no CUDA device is present. `--device cpu` renders
with the plain torch versions of the kernels.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pbrt_tpu_torch")
    ap.add_argument("scenes", nargs="*", help=".pbrt scene files")
    ap.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ap.add_argument("--outfile", default="", help="output image path")
    ap.add_argument("--quick", action="store_true",
                    help="quarter resolution / one sample per pixel for fast iteration")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="print the statistics counters at WorldEnd")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default="",
                    help="film checkpoint file (npz) for crash-resumable renders")
    ap.add_argument("--tile-samples", type=int, default=0,
                    help="camera samples per wavefront tile (0 = 65536; 16384 for "
                         "the photon integrators)")
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("pbrt_tpu_torch: no CUDA device available (use --device cpu to render "
              "on the CPU)", file=sys.stderr)
        return 1
    if not args.scenes:
        print("pbrt_tpu_torch: reading scene from stdin is not supported; "
              "pass a scene file", file=sys.stderr)
        return 1

    from pbrt_tpu_torch.core.error import PbrtError
    from pbrt_tpu_torch.scene import api, parser

    api.pbrt_init({
        "device": args.device,
        "imageFile": args.outfile,
        "quick": args.quick,
        "quiet": args.quiet,
        "verbose": args.verbose,
        "seed": args.seed,
        "checkpoint": args.checkpoint or None,
        "tile_samples": args.tile_samples,
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
    finally:
        api._state.__init__()
    return 0


if __name__ == "__main__":
    sys.exit(main())
