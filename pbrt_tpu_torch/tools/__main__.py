"""Tool dispatcher: python -m pbrt_tpu_torch.tools <tool> [args...]

Port of pbrt_tpu/tools/__main__.py. Tools (reference tools/ directory):
exrdiff exravg exrtotiff tifftoexr (tools/exrtools.py), obj2pbrt
ply2pbrt (tools/converters.py), bsdftest (tools/bsdftest.py; on the card
unless given --device cpu) and samplepat. Only bsdftest touches a
device.
"""
import sys

TOOLS = ("exrdiff", "exravg", "exrtotiff", "tifftoexr", "obj2pbrt", "ply2pbrt", "bsdftest",
         "samplepat")


def samplepat(argv=None) -> int:
    """Generate a best-candidate (Poisson-ish dart throwing) sample
    table (reference tools/samplepat.cpp -> samplers/bestcandidate.out):
    samplepat [out.npy] [n], the JAX package's table for the same n."""
    import numpy as np

    argv = list(sys.argv[1:] if argv is None else argv)
    out = argv[0] if argv else "bestcandidate.npy"
    n = int(argv[1]) if len(argv) > 1 else 4096
    rng = np.random.RandomState(0)
    pts = [rng.rand(2)]
    for _ in range(n - 1):
        cand = rng.rand(256, 2)
        # toroidal distance to the existing set; keep the farthest candidate
        d = np.abs(cand[:, None, :] - np.asarray(pts)[None, :, :])
        d = np.minimum(d, 1.0 - d)
        dist = np.sqrt((d ** 2).sum(-1)).min(1)
        pts.append(cand[np.argmax(dist)])
    np.save(out, np.asarray(pts, np.float32))
    print(f"samplepat: wrote {n} best-candidate samples to {out}")
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(f"usage: python -m pbrt_tpu_torch.tools <{'|'.join(TOOLS)}> [args...]",
              file=sys.stderr)
        return 1
    tool, args = argv[0], argv[1:]
    if tool in ("exrdiff", "exravg", "exrtotiff", "tifftoexr"):
        from pbrt_tpu_torch.tools import exrtools

        return getattr(exrtools, tool)(args)
    if tool in ("obj2pbrt", "ply2pbrt"):
        from pbrt_tpu_torch.tools import converters

        return getattr(converters, tool)(args)
    if tool == "bsdftest":
        from pbrt_tpu_torch.tools.bsdftest import bsdftest

        return bsdftest(args)
    if tool == "samplepat":
        return samplepat(args)
    print(f"unknown tool {tool!r}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
