"""emap_tpu_torch: the PyTorch + CUDA port of emap_tpu.

The layout mirrors `emap_tpu/` module for module. The port imports torch,
numpy and the standard library only; it never imports jax or emap_tpu.

Precision: every path of this package computes at float32 accuracy. The
field query's CUDA kernels (training, extraction sweeps and grid) multiply
on the tensor cores with a 3xTF32 split (csrc/mlp_mma.cuh), and torch
matmuls run in full float32 with TF32 off (`use_fp32_matmuls`, called by
the runner and `chip_smoke.py`). The
conf keys `precision`, `field_precision`, `sampler_precision` and
`bwd_precision` are parsed but do not yet select a tier.
"""

import torch


def use_fp32_matmuls() -> None:
    """The one place the port sets its matmul precision: full float32, no
    TF32 (TF32 keeps ~3 decimal digits; the field's near-surface decisions
    sit at udf ~1e-2). The port runs no convolutions, so cuDNN's flag is
    left alone."""
    torch.backends.cuda.matmul.allow_tf32 = False


def default_device() -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU."""
    return torch.device("cuda")
