#!/usr/bin/env python3
"""Store one launch of #2's wgmma kernels at the (bf16, bf16) pair
(csrc/mlp_train_wgmma.cu and the GEMM and reduce of
csrc/mlp_train_gemm.cuh) on fixed inputs, for tests/test_torch_cuda.py to
hold later builds of the kernels to, bit for bit, on one NVIDIA GPU.

    python3 scripts/torch_train_wgmma_fixture.py OUT.npz [CSRC_DIR]

The inputs are integer hashes (scripts/torch_query_tf32_fixture.py:
hashed_inputs, ABC.conf's net width, 1,024 points) and hashed cotangents
ubar and gbar (rows 0-2), the same under any PyTorch. CSRC_DIR (default:
this checkout's emap_tpu_torch/csrc) is the source tree the library is
built from, so the launch of another checkout's kernels can be stored
through this checkout's wrapper. Writes W-bar and b-bar at "default". No
CPU fallback: without CUDA it fails.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))


def query_fixture():
    """scripts/torch_query_tf32_fixture.py, for its hashed inputs."""
    spec = importlib.util.spec_from_file_location(
        "query_tf32_fixture", os.path.join(HERE, "torch_query_tf32_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def hashed_inputs(cfg):
    """(x_T, w_pack, b_pack, ubar (1, n), gbar (8, n)) as numpy fp32:
    hashed_inputs' points and weights, cotangents in [-1, 1)."""
    fixture = query_fixture()
    x, w, b = fixture.hashed_inputs(cfg)
    n = x.shape[1]
    ubar = fixture.hashed((1, n), 300, 1.0)
    gbar = np.zeros((8, n), np.float32)
    gbar[:3] = fixture.hashed((3, n), 301, 1.0)
    return x, w, b, ubar, gbar


def main(argv) -> int:
    import dataclasses

    import torch

    from emap_tpu_torch.fields import udf as tudf
    from emap_tpu_torch.kernels import build, mlp_train

    if not torch.cuda.is_available():
        raise SystemExit("torch_train_wgmma_fixture: needs a CUDA GPU")
    if len(argv) not in (1, 2):
        raise SystemExit(__doc__)
    if len(argv) == 2:
        build.CSRC = os.path.abspath(argv[1])
    cfg = dataclasses.replace(tudf.UDFConfig(), precision="default")
    args = [torch.as_tensor(a).cuda() for a in hashed_inputs(cfg)]
    wbar, bbar = mlp_train.train_bwd(*args, cfg)
    np.savez_compressed(argv[0], wbar=wbar.cpu().numpy(),
                        bbar=bbar.cpu().numpy())
    print(f"stored wbar, bbar of {build.lib_path('mlp_train_wgmma')} to "
          f"{argv[0]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
