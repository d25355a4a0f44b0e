#!/usr/bin/env python3
"""Store one launch of the 3xTF32 query kernel (csrc/mlp_query_tf32.cu) on
fixed inputs, for tests/test_torch_cuda.py to hold later builds of the
kernel to, bit for bit, on one NVIDIA GPU.

    python3 scripts/torch_query_tf32_fixture.py OUT.npz [CSRC_DIR]

The inputs are made from integer hashes (`hashed_inputs`), not from a
random generator, so they are the same under any PyTorch: ABC.conf's net
width, 1,024 points. CSRC_DIR (default: this checkout's
emap_tpu_torch/csrc) is the source tree the library is built from, so the
launch of another checkout's kernel can be stored through this
checkout's wrapper. Writes udf and the gradient's three live rows at
"high", with fp32 and with bf16 sigmoid residuals. No CPU fallback:
without CUDA it fails.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

N_POINTS = 1024


def hashed(shape, seed: int, scale: float) -> np.ndarray:
    """fp32 values in [-scale, scale) from a multiplicative hash of each
    element's index and the seed: exact on every machine."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed)
    h = (i * np.uint64(2654435761) + np.uint64(0x9E3779B9)) % np.uint64(
        1 << 24)
    u = h.astype(np.float64) / float(1 << 24)
    return ((2.0 * u - 1.0) * scale).astype(np.float32).reshape(shape)


def hashed_inputs(cfg, n: int = N_POINTS):
    """(x_T (8, n), w_pack, b_pack) as numpy fp32 for cfg's net: points in
    [-1, 1) (rows 3-7 zero), weights +-0.1 in every live block of the pack
    (zero elsewhere), biases +-0.05."""
    from emap_tpu_torch.kernels import mlp_query

    x = np.zeros((8, n), np.float32)
    x[:3] = hashed((3, n), 1, 1.0)
    dims = mlp_query.layer_dims(cfg)
    rmax, ldw = max(o for _, o in dims), sum(i for i, _ in dims)
    w = np.zeros((rmax, ldw), np.float32)
    off = 0
    for l, (i, o) in enumerate(dims):
        w[:o, off: off + i] = hashed((o, i), 100 + l, 0.1)
        off += i
    b = np.zeros((rmax, len(dims)), np.float32)
    for l, (_, o) in enumerate(dims):
        b[:o, l] = hashed((o,), 200 + l, 0.05)
    return x, w, b


def main(argv) -> int:
    import dataclasses

    import torch

    from emap_tpu_torch.fields import udf as tudf
    from emap_tpu_torch.kernels import build, mlp_query

    if not torch.cuda.is_available():
        raise SystemExit("torch_query_tf32_fixture: needs a CUDA GPU")
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    if len(argv) == 2:
        build.CSRC = os.path.abspath(argv[1])
    cfg = dataclasses.replace(tudf.UDFConfig(), precision="high")
    x, w, b = (torch.as_tensor(a).cuda() for a in hashed_inputs(cfg))
    out = {}
    for tag, f32 in (("f32", True), ("bf16", False)):
        udf, grad = mlp_query.value_and_grad(x, w, b, cfg, f32_residuals=f32)
        out[f"udf_{tag}"] = udf.cpu().numpy()
        out[f"grad_{tag}"] = grad[:3].cpu().numpy()
    np.savez_compressed(argv[0], **out)
    print(f"stored {sorted(out)} of {build.lib_path('mlp_query_tf32')} to "
          f"{argv[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
