"""pbrt_tpu_torch — the pbrt_tpu renderer ported to PyTorch + CUDA.

A second package beside `pbrt_tpu` (the JAX reference). Module paths and
function names mirror `pbrt_tpu/` so each counterpart is easy to find.
Plain tensor code is PyTorch on an explicit `device`, float32
throughout; the two Pallas t-pass kernels of the reference are CUDA C++
kernels for Hopper under `csrc/` (see ops/intersect_cuda.py and
ops/bvh_cuda.py). The package imports torch, numpy and the standard
library only.
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of pbrt_tpu/__init__.py's "highest" matmul precision: the
# spectral contractions (spectrum -> XYZ/luminance) must run in exact
# f32. TF32 keeps ~10 mantissa bits, the same trap as the TPU's bf16
# MXU passes that once cost 25% of image energy.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
