#!/usr/bin/env python3
"""Where the training field query's CUDA kernels spend their time, by
ablation, on one NVIDIA GPU.

    python3 scripts/torch_kernel_ablation.py [NAME ...]

Each ablation is a copy of emap_tpu_torch/csrc with one part of the design
removed or changed (a source patch below), built with nvcc beside the
others and timed at the training step's shape: ABC width, 116,736 points,
CUDA events over 5 launches after a warm-up, in two rounds (ablations in
turns). Every line gives the forward (#1a, mlp_query.cu) and backward (#2,
mlp_train.cu) times, the backward's two main kernels from torch.profiler,
and the max relative error of udf, grad and the worst W-bar/b-bar block
against the plain PyTorch versions. Ablations that drop work give wrong
results by design: they measure what that work costs. The card's name and
power limit lead the output. No CPU fallback: without CUDA it fails.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

THREE_PASSES = """        mma_tf32(acc[mt][nt], al, bh[nt]);
        mma_tf32(acc[mt][nt], ah, bl[nt]);
        mma_tf32(acc[mt][nt], ah, bh[nt]);"""
# name: {file: [(text in the source, replacement)]}
ABLATIONS = {
    "as_built": {},
    # one mma chain over the whole contraction: no fresh accumulator per
    # 32 steps (shows the tensor cores' truncating accumulation)
    "no_promotion": {
        "mlp_mma.cuh": [("""    Acc part;
    zero_acc(part);
    mma_chunk<KC>(
        part, f, M,""", """    mma_chunk<KC>(
        acc, f, M,"""), ("""          split3(xk[kk * SA + p], h, l);
        });
    add_acc(acc, part);""", """          split3(xk[kk * SA + p], h, l);
        });""")],
        "mlp_train.cu": [("""    Acc part;
    zero_acc(part);
    mma_chunk<KW>(
        part, f, out - o0,""", """    mma_chunk<KW>(
        acc, f, out - o0,"""), ("""          split3(b[i * SWB + kk], h, lo);
        });
    add_acc(acc, part);""", """          split3(b[i * SWB + kk], h, lo);
        });""")],
    },
    # one TF32 pass (hi * hi) instead of three: what two thirds of the mma
    # cost, with the rounding of the lo halves they alone use
    "one_pass": {"mlp_mma.cuh": [
        (THREE_PASSES, "        mma_tf32(acc[mt][nt], ah, bh[nt]);")]},
    # each weight chunk split once, as it lands, into hi (in place) and lo
    # (one more ring slot) by the whole block, behind one more barrier; the
    # warps then read the halves instead of splitting as they read
    "split_at_staging": {"mlp_mma.cuh": [
        ("constexpr int RING = NSLOT * SLOT;",
         "constexpr int RING = (NSLOT + 1) * SLOT;"),
        ("    const float* cur = ring + (c % NSLOT) * SLOT;\n",
         """    float* cur = ring + (c % NSLOT) * SLOT;
    unsigned* lo_s = reinterpret_cast<unsigned*>(ring + NSLOT * SLOT);
    for (int i = threadIdx.x; i < (TRANS ? KC * ST : Mr * SW); i += NT) {
      unsigned h;
      split3(cur[i], h, lo_s[i]);
      cur[i] = __uint_as_float(h);
    }
    __syncthreads();
"""),
        ("          split3(cur[at(m, kk)], h, l);",
         "          h = __float_as_uint(cur[at(m, kk)]);\n"
         "          l = lo_s[at(m, kk)];")]},
    # the same for the contraction's factor chunks, into two more slots
    "split_contraction_at_staging": {"mlp_train.cu": [
        ("const size_t wb_bytes = 2 * 2 * BT * SWB * sizeof(float);",
         "const size_t wb_bytes = 4 * 2 * BT * SWB * sizeof(float);"),
        ("""    const float* b = a + BT * SWB;
    Acc part;
    zero_acc(part);
    mma_chunk<KW>(
        part, f, out - o0,
        [&](int m, int kk, unsigned& h, unsigned& lo) {
          split3(a[m * SWB + kk], h, lo);
        },
        [&](int kk, int i, unsigned& h, unsigned& lo) {
          split3(b[i * SWB + kk], h, lo);
        });""", """    const float* b = a + BT * SWB;
    unsigned* hs = reinterpret_cast<unsigned*>(ring + 2 * SLOT2);
    unsigned* ls = hs + SLOT2;
    for (int q = threadIdx.x; q < SLOT2; q += NT) split3(a[q], hs[q], ls[q]);
    __syncthreads();
    Acc part;
    zero_acc(part);
    mma_chunk<KW>(
        part, f, out - o0,
        [&](int m, int kk, unsigned& h, unsigned& lo) {
          h = hs[m * SWB + kk];
          lo = ls[m * SWB + kk];
        },
        [&](int kk, int i, unsigned& h, unsigned& lo) {
          h = hs[(BT + i) * SWB + kk];
          lo = ls[(BT + i) * SWB + kk];
        });""")]},
    # the forward epilogues without softplus / sigmoid
    "no_activation_math": {
        "mlp_query.cu": [("sig_softplus100(acc[mt][nt][e] + B[m * L + l], "
                          "sig[e], a);",
                          "sig[e] = a = acc[mt][nt][e];")],
        "mlp_train.cu": [("sig_softplus100(acc[mt][nt][e] + B[m * L + l], "
                          "sig[e], a[e]);",
                          "sig[e] = a[e] = acc[mt][nt][e];")],
    },
}


def patched_tree(root: str, name: str) -> str:
    from emap_tpu_torch.kernels import build

    dst = os.path.join(root, name)
    shutil.copytree(build.CSRC, dst)
    for fn, edits in ABLATIONS[name].items():
        path = os.path.join(dst, fn)
        with open(path) as f:
            src = f.read()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"ablation {name}: {fn} no longer holds "
                                 f"the patched text:\n{old}")
            src = src.replace(old, new)
        with open(path, "w") as f:
            f.write(src)
    return dst


def main(names) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from emap_tpu_torch.fields import udf as tudf
    from emap_tpu_torch.kernels import build
    from emap_tpu_torch.kernels import mlp_query as tq
    from emap_tpu_torch.kernels import mlp_train as tt

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ablation: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    cfg = tudf.UDFConfig()
    gen = torch.Generator().manual_seed(0)
    params = tudf.init_udf_params(gen, cfg, device="cpu")
    params = {k: {n: (t + 0.05 * torch.randn(t.shape, generator=gen)).cuda()
                  for n, t in layer.items()} for k, layer in params.items()}
    w, b = (t.detach().contiguous() for t in tq.pack_weights(params, cfg))
    n = 1024 * 114
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.zeros(8, n, device="cuda")
    x[:3] = torch.rand(3, n, generator=g, device="cuda") * 2 - 1
    ub = torch.randn(1, n, generator=g, device="cuda")
    gb = torch.zeros(8, n, device="cuda")
    gb[:3] = torch.randn(3, n, generator=g, device="cuda")
    u_p, g_p = tq.value_and_grad_plain(x, w, b, cfg)
    bwd_p = tq.unpack_weights(*tt.train_bwd_plain(x, w, b, ub, gb, cfg), cfg)

    def rel(a, c):
        return float((a - c).abs().max() / (c.abs().max() + 1e-30))

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    with tempfile.TemporaryDirectory() as root:
        trees = {name: patched_tree(root, name) for name in names}
        for tree in trees.values():
            build.CSRC = tree
            build.build_all(("mlp_query", "mlp_train"))
        for rnd in range(2):
            for name, tree in trees.items():
                build.CSRC = tree
                build._loaded.clear()
                u, gr = tq.value_and_grad(x, w, b, cfg)
                bwd = tq.unpack_weights(*tt.train_bwd(x, w, b, ub, gb, cfg),
                                        cfg)
                torch.cuda.synchronize()
                worst = max(rel(a, c) for got, want in zip(bwd, bwd_p)
                            for a, c in zip(got, want))
                fwd_ms = ms(lambda: tq.value_and_grad(x, w, b, cfg))
                bwd_ms = ms(lambda: tt.train_bwd(x, w, b, ub, gb, cfg))
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    tt.train_bwd(x, w, b, ub, gb, cfg)
                    torch.cuda.synchronize()
                parts = {}
                for e in prof.key_averages():
                    m = re.search(r"(\w+_kernel)\(", e.key)
                    if m:
                        parts[m.group(1)] = getattr(
                            e, "device_time_total", 0.0) / 1e3
                print(f"round {rnd} {name:20s} fwd {fwd_ms:8.3f} ms  bwd "
                      f"{bwd_ms:8.3f} ms (per_point "
                      f"{parts.get('per_point_kernel', 0.0):.3f}, "
                      f"wbar_partials "
                      f"{parts.get('wbar_partials_kernel', 0.0):.3f})  "
                      f"max rel err udf {rel(u, u_p):.2e} grad "
                      f"{rel(gr, g_p):.2e} wbar {worst:.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(ABLATIONS)))
