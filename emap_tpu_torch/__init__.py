"""emap_tpu_torch: the PyTorch + CUDA port of emap_tpu.

The layout mirrors `emap_tpu/` module for module. The port imports torch,
numpy and the standard library only; it never imports jax or emap_tpu.

Precision: the conf keys select the JAX package's matmul tiers
(fields/udf.py::TIERS) at the sites it reads them:
- `model.udf_renderer.field_precision` (default "default"): the training
  field query, kernels #1a and #2, and the validation render; "" keeps the
  model tier. A conf that pins `model.udf_network.precision` and not this
  key trains at the pinned tier (train/runner.py).
- `model.udf_network.bwd_precision` (default ""): #2's adjoint products;
  "" inherits the field tier.
- `model.udf_renderer.sampler_precision` (default "default"): the
  up-sampler's field queries (torch matmuls).
- `model.udf_network.precision` (default "high"): extraction, kernels #1b
  and #3.
"default" is one bf16 pass (operands rounded to bf16, fp32 products, sums
and results: wgmma bf16 in #1 and #2, mma.sync bf16 in #3, a TF32 matmul
of bf16-rounded operands elsewhere); "high" and "highest" are fp32
(3xTF32 in the kernels, fp32 matmuls elsewhere). "highest" on the field
also routes the training query through plain autograd instead of the
kernels, as the JAX package routes it through XLA autodiff
(`pallas_train = "on"` keeps the kernels).
The fp32 path throughout: pin `precision = "high"` in udf_network (the
field follows it) and `sampler_precision = "high"` in udf_renderer.
Outside those sites torch matmuls run in full float32 with TF32 off
(`use_fp32_matmuls`, called by the runner and `chip_smoke.py`).
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
