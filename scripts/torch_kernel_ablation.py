#!/usr/bin/env python3
"""Where the field query's CUDA kernels spend their time, by ablation, on
one NVIDIA GPU.

    python3 scripts/torch_kernel_ablation.py [NAME ...]

Each ablation is a copy of emap_tpu_torch/csrc with one part of the design
removed or changed (a source patch below), built with nvcc beside the
others and timed with CUDA events over 5 launches after a warm-up, in two
rounds (ablations in turns). Only the kernels whose sources an ablation
changes are timed for it (all of them for as_built): the training kernels
at the training step's shape (ABC width, 116,736 points), forward (#1a:
mlp_query.cu's mma.sync design, value_and_grad_mma_sync) and backward (#2,
mlp_train.cu's mma.sync design, train_bwd_mma_sync, with its two main
kernels from torch.profiler, and mlp_train_tf32.cu's wgmma one at the
3xTF32 and mixed pairs, with its per-point and GEMM kernels), and the grid
value kernel (#3: mlp_value.cu's mma.sync design, value_mma_sync, and
mlp_value_tf32.cu's wgmma one, with its two launches from torch.profiler)
at a 128^3 grid pass (2,097,152 points).
Every line gives the max relative error against the plain PyTorch
versions (udf, grad, the worst W-bar/b-bar block), and ptxas' registers
and spills lead each ablation's lines.
Every ablation runs at the 3xTF32 tier (precision "high", fp32 accuracy),
the tier the design choices were made for; its patches leave the bf16
tier's kernels in the same libraries building. The wgmma_* ablations
patch #2's wgmma kernels (mlp_train_wgmma.cu) and are timed at the
(bf16, bf16) pair those serve, with their per-point and GEMM kernels from
torch.profiler and the max and mean error against the plain version at
that pair. The query_wgmma_* ablations patch #1a's wgmma kernel
(mlp_query_wgmma.cu) and are timed at the bf16 tier it serves, with its
two launches from torch.profiler and the max and mean error against the
plain version at that tier. The query_tf32_* ablations patch #1's 3xTF32
kernel (mlp_query_tf32.cu, the route of "high" and "highest"), timed at
that tier with fp32 residuals (#1a's field_high route) and with bf16 ones
(#1b's extraction sweeps), its two launches from torch.profiler and the
max and mean error against the plain version (the gradient against the
plain version given the kernel's own residuals with bf16 ones:
kernels/mlp_query.py::side_residuals). The value_tf32_* ablations patch
#3's 3xTF32 kernel (mlp_value_tf32.cu), timed at a 128^3 grid pass; the
value_wgmma_* ones #3's bf16 kernel (mlp_value_wgmma.cu), timed at that
tier at a 128^3 grid pass, its two launches from torch.profiler and the
max and mean error against the plain version at that tier.
The train_tf32_* ablations patch #2's kernels at the pairs with a
3xTF32 tier (mlp_train_tf32.cu), timed at the 3xTF32 and mixed pairs.
Ablations that drop work give wrong
results by
design: they measure what that work costs. The card's name and power
limit lead the output. No CPU fallback: without CUDA it fails.

    python3 scripts/torch_kernel_ablation.py as_built --tree parent=DIR

also builds the CUDA sources of another checkout of the repo at DIR (its
emap_tpu_torch/csrc, unpatched) as a variant named `parent`, timed in the
same rounds through this checkout's wrappers on the libraries both
checkouts have. Every line of a variant says whether its outputs equal
as_built's bit for bit (as_built first among the names).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

THREE_PASSES = """          mma_tf32(acc[mt][nt], al, bh[nt]);
          mma_tf32(acc[mt][nt], ah, bl[nt]);
          mma_tf32(acc[mt][nt], ah, bh[nt]);"""
# For the ablations that split an operand once, as its chunk lands: a
# reader of mma_chunk's TF32X3 branch may return the two halves instead of
# the value, and split_any takes either.
STAGED = """// An operand split before it is read: hi and lo as floats.
struct Staged {
  float hi, lo;
};
__device__ __forceinline__ void split_any(float x, unsigned& h, unsigned& l) {
  split3(x, h, l);
}
__device__ __forceinline__ void split_any(Staged x, unsigned& h,
                                          unsigned& l) {
  h = __float_as_uint(x.hi);
  l = __float_as_uint(x.lo);
}

// acc += A X over one KD-deep chunk at tier T."""
A_SPLITS = """        split3(a_at(m, ks + f.tig), ah[0], al[0]);
        split3(a_at(m + 8, ks + f.tig), ah[1], al[1]);
        split3(a_at(m, ks + f.tig + 4), ah[2], al[2]);
        split3(a_at(m + 8, ks + f.tig + 4), ah[3], al[3]);"""
B_SPLITS = """        split3(b_at(ks + f.tig, n), bh[nt][0], bl[nt][0]);
        split3(b_at(ks + f.tig + 4, n), bh[nt][1], bl[nt][1]);"""
# name: {file: [(text in the source, replacement)]}. The ablations measure
# the 3xTF32 tier: where one changes the operand split, the BF16 kernels of
# the same library keep reading plain values.
ABLATIONS = {
    "as_built": {},
    # one mma chain over the whole contraction: no fresh accumulator per
    # 32 steps (shows the tensor cores' truncating accumulation)
    "no_promotion": {
        "mlp_mma.cuh": [("""    Acc part;
    zero_acc(part);
    mma_chunk<T, KC>(
        part, f, M, [&](int m, int kk) { return cur[at(m, kk)]; },
        [&](int kk, int p) { return xk[kk * SA + p]; });
    add_acc(acc, part);""", """    mma_chunk<T, KC>(
        acc, f, M, [&](int m, int kk) { return cur[at(m, kk)]; },
        [&](int kk, int p) { return xk[kk * SA + p]; });""")],
        "mlp_train.cu": [("""    Acc part;
    zero_acc(part);
    mma_chunk<TA, KW>(
        part, f, out - o0, [&](int m, int kk) { return a[m * SWB + kk]; },
        [&](int kk, int i) { return b[i * SWB + kk]; });
    add_acc(acc, part);""", """    mma_chunk<TA, KW>(
        acc, f, out - o0, [&](int m, int kk) { return a[m * SWB + kk]; },
        [&](int kk, int i) { return b[i * SWB + kk]; });""")],
    },
    # one TF32 pass (hi * hi) instead of three: what two thirds of the mma
    # cost, with the rounding of the lo halves they alone use (not the bf16
    # tier: TF32 operands keep 10 mantissa bits, bf16 ones 7)
    "one_pass": {"mlp_mma.cuh": [
        (THREE_PASSES, "          mma_tf32(acc[mt][nt], ah, bh[nt]);")]},
    # each weight chunk split once, as it lands, into hi (in place) and lo
    # (one more ring slot) by the whole block, behind one more barrier; the
    # warps then read the halves instead of splitting as they read
    "split_at_staging": {"mlp_mma.cuh": [
        ("constexpr int RING = NSLOT * SLOT;",
         "constexpr int RING = (NSLOT + 1) * SLOT;"),
        ("// acc += A X over one KD-deep chunk at tier T.", STAGED),
        (A_SPLITS, A_SPLITS.replace("split3(", "split_any(")),
        ("    const float* cur = ring + (c % NSLOT) * SLOT;\n",
         """    float* cur = ring + (c % NSLOT) * SLOT;
    float* lo_s = ring + NSLOT * SLOT;
    if constexpr (T == TF32X3) {
      for (int i = threadIdx.x; i < (TRANS ? KC * ST : Mr * SW); i += NT) {
        unsigned h, l;
        split3(cur[i], h, l);
        cur[i] = __uint_as_float(h);
        lo_s[i] = __uint_as_float(l);
      }
      __syncthreads();
    }
"""),
        ("        part, f, M, [&](int m, int kk) { return cur[at(m, kk)]; },",
         """        part, f, M,
        [&](int m, int kk) {
          if constexpr (T == TF32X3)
            return Staged{cur[at(m, kk)], lo_s[at(m, kk)]};
          else
            return cur[at(m, kk)];
        },""")]},
    # the same for the contraction's factor chunks, into two more slots
    "split_contraction_at_staging": {
        "mlp_mma.cuh": [
            ("// acc += A X over one KD-deep chunk at tier T.", STAGED),
            (A_SPLITS, A_SPLITS.replace("split3(", "split_any(")),
            (B_SPLITS, B_SPLITS.replace("split3(", "split_any("))],
        "mlp_train.cu": [
            ("const size_t wb_bytes = 2 * 2 * BT * SWB * sizeof(float);",
             "const size_t wb_bytes = 4 * 2 * BT * SWB * sizeof(float);"),
            ("""    const float* b = a + BT * SWB;
    Acc part;
    zero_acc(part);
    mma_chunk<TA, KW>(
        part, f, out - o0, [&](int m, int kk) { return a[m * SWB + kk]; },
        [&](int kk, int i) { return b[i * SWB + kk]; });""",
             """    const float* b = a + BT * SWB;
    float* hs = ring + 2 * SLOT2;
    float* ls = hs + SLOT2;
    if constexpr (TA == TF32X3) {
      for (int q = threadIdx.x; q < SLOT2; q += NT) {
        unsigned h, l;
        split3(a[q], h, l);
        hs[q] = __uint_as_float(h);
        ls[q] = __uint_as_float(l);
      }
      __syncthreads();
    }
    Acc part;
    zero_acc(part);
    mma_chunk<TA, KW>(
        part, f, out - o0,
        [&](int m, int kk) {
          if constexpr (TA == TF32X3)
            return Staged{hs[m * SWB + kk], ls[m * SWB + kk]};
          else
            return a[m * SWB + kk];
        },
        [&](int kk, int i) {
          if constexpr (TA == TF32X3)
            return Staged{hs[(BT + i) * SWB + kk], ls[(BT + i) * SWB + kk]};
          else
            return b[i * SWB + kk];
        });""")]},
    # the forward epilogues without softplus / sigmoid
    "no_activation_math": {
        "mlp_query.cu": [("sig_softplus100(acc[mt][nt][e] + B[m * L + l], "
                          "sig[e], a);",
                          "sig[e] = a = acc[mt][nt][e];")],
        "mlp_train.cu": [("sig_softplus100(acc[mt][nt][e] + B[m * L + l], "
                          "sig[e], a[e]);",
                          "sig[e] = a[e] = acc[mt][nt][e];")],
        "mlp_value.cu": [("softplus100(acc[mt][nt][e] + B[m * L + l]) * s;",
                          "(acc[mt][nt][e] + B[m * L + l]) * s;")],
    },
    # #3 on a 128-point tile: 16 warps (4 x 4 over 256 rows x 128 points),
    # which halves the weight traffic from L2 a point; to fit in shared
    # memory the ring has 16-step slots (sums promoted every 16 steps)
    "p128": {
        "mlp_common.cuh": [("constexpr int P = 64;", "constexpr int P = 128;"),
                           ("constexpr int NT = 256;",
                            "constexpr int NT = 512;")],
        "mlp_mma.cuh": [("constexpr int KC = 32;", "constexpr int KC = 16;"),
                        ("  return {w >> 1, w & 1, lane >> 2, lane & 3};",
                         "  return {w >> 2, w & 3, lane >> 2, lane & 3};")]},
    # #3 with the hidden weights split into (hi, lo) once a launch by a
    # small kernel, into a pack laid out in mma.sync's A-fragment order
    # (stream-ordered allocation in the launch): each layer's ring streams
    # the pack (twice the L2 bytes; two 64 KB slots) and each warp reads its
    # split fragments as two 16-byte loads instead of splitting four values
    # (the BF16 instantiation takes the same 3xTF32 products; not timed)
    "presplit_weights": {"mlp_value.cu": [
        ("  return (size_t)RING + (size_t)(ts.ar + ts.xr) * SA + 4 * P;",
         "  return (size_t)4 * WMAX * KC + (size_t)(ts.ar + ts.xr) * SA + "
         "4 * P;"),
        ("  float* act = ring + RING;", "  float* act = ring + 4 * WMAX * KC;"),
        ("""template <Tier T>
__global__ void __launch_bounds__(NT, 1)
    mlp_value_kernel(const float* pts, const float* __restrict__ W,
                     const float* __restrict__ B, float* udf, Layout lay,
                     size_t ld) {""",
         """// chunk q (KC steps of a hidden layer, layer by layer) of the pack at
// pack + q CH, split, laid out [ks 8-step][m16 tile][hi, lo][lane][A-fragment
// element], zero past out and in
constexpr int CH = 2 * WMAX * KC;
__global__ void split_weights_kernel(const float* __restrict__ W,
                                     float* pack, Layout lay, int nq) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < (size_t)nq * WMAX * KC; e += (size_t)gridDim.x * blockDim.x) {
    const int j = e & 3, lane = (e >> 2) & 31, t = (e >> 7) % (WMAX / 16);
    const int ks = (e / (8 * WMAX)) % (KC / 8), q = e / (WMAX * KC);
    int l = 0, c = q;
    while (l < lay.L - 2 && c >= (lay.in[l] + KC - 1) / KC)
      c -= (lay.in[l++] + KC - 1) / KC;
    const int m = t * 16 + (lane >> 2) + (j & 1) * 8;
    const int k = c * KC + ks * 8 + (lane & 3) + (j >> 1) * 4;
    const float v = m < lay.out[l] && k < lay.in[l]
                        ? W[(size_t)m * lay.ldw + lay.off[l] + k] : 0.f;
    unsigned hi, lo;
    split3(v, hi, lo);
    float* dst = pack + (size_t)q * CH +
                 ((ks * (WMAX / 16) + t) * 2) * 128 + lane * 4 + j;
    dst[0] = __uint_as_float(hi);
    dst[128] = __uint_as_float(lo);
  }
}

// tc_product<TF32X3, false> from a layer's chunks of the pack, in a
// two-slot ring
__device__ __forceinline__ void split_product(const float* pk, int M, int K,
                                              const float* xs, float* ring,
                                              Acc& acc) {
  const Frag f = frag_points();
  zero_acc(acc);
  const int nch = (K + KC - 1) / KC;
  auto load = [&](int c) {
    if (c < nch)
      for (int s = threadIdx.x; s < CH / 4; s += NT)
        cp16(ring + (c % 2) * CH + 4 * s, pk + (size_t)c * CH + 4 * s, true);
    cp_commit();
  };
  load(0);
  for (int c = 0; c < nch; ++c) {
    cp_wait<0>();
    __syncthreads();
    load(c + 1);
    const float* cur = ring + (c % 2) * CH;
    const float* xk = xs + (size_t)c * KC * SA;
    Acc part;
    zero_acc(part);
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = f.wn * 32 + nt * 8 + f.gid;
        split3(xk[(ks + f.tig) * SA + n], bh[nt][0], bl[nt][0]);
        split3(xk[(ks + f.tig + 4) * SA + n], bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (f.wm * 64 + mt * 16 >= M) continue;  // warp-uniform
        const uint4* a4 = reinterpret_cast<const uint4*>(
            cur + ((ks / 8 * (WMAX / 16) + f.wm * 4 + mt) * 2) * 128) +
            (threadIdx.x & 31);
        const uint4 h4 = a4[0], l4 = a4[32];
        const unsigned ah[4] = {h4.x, h4.y, h4.z, h4.w};
        const unsigned al[4] = {l4.x, l4.y, l4.z, l4.w};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(part[mt][nt], al, bh[nt]);
          mma_tf32(part[mt][nt], ah, bl[nt]);
          mma_tf32(part[mt][nt], ah, bh[nt]);
        }
      }
    }
    add_acc(acc, part);
  }
  __syncthreads();
}

template <Tier T>
__global__ void __launch_bounds__(NT, 1)
    mlp_value_kernel(const float* pts, const float* __restrict__ W,
                     const float* __restrict__ B, float* udf,
                     const float* __restrict__ pack, Layout lay,
                     size_t ld) {"""),
        ("  const float* h = X;\n",
         "  const float* h = X;\n  int q = 0;  // the layer's first chunk\n"),
        ("""    tc_product<T, false>(W + lay.off[l], lay.ldw, M, lay.in[l], h, ring,
                         acc);""",
         "    split_product(pack + (size_t)q * CH, M, lay.in[l], h, ring, "
         "acc);\n    q += (lay.in[l] + KC - 1) / KC;"),
        ("""  mlp_value_kernel<T><<<(unsigned)(n / P), NT, bytes, stream>>>(
      pts, W, B, udf, lay, (size_t)n);
  return (int)cudaGetLastError();""", """  int nq = 0;
  for (int l = 0; l < lay.L - 1; ++l) nq += (lay.in[l] + KC - 1) / KC;
  float* pack = nullptr;
  const cudaError_t e2 = cudaMallocAsync(
      (void**)&pack, (size_t)nq * CH * sizeof(float), stream);
  if (e2 != cudaSuccess) return (int)e2;
  split_weights_kernel<<<(nq * WMAX * KC + 255) / 256, 256, 0, stream>>>(
      W, pack, lay, nq);
  mlp_value_kernel<T><<<(unsigned)(n / P), NT, bytes, stream>>>(
      pts, W, B, udf, pack, lay, (size_t)n);
  cudaFreeAsync(pack, stream);
  return (int)cudaGetLastError();""")]},
    # #3's hidden weights as ONE stream of 32-step chunks over all layers
    # through a three-slot ring, two chunks ahead of the warps: the next
    # layer's first chunks land while this layer's last one is multiplied
    # and its epilogue runs (tc_product's ring drains at each layer's end)
    "layer_stream": {"mlp_value.cu": [
        ("  return (size_t)RING + (size_t)(ts.ar + ts.xr) * SA + 4 * P;",
         "  return (size_t)3 * SLOT + (size_t)(ts.ar + ts.xr) * SA + 4 * P;"),
        ("  float* act = ring + RING;", "  float* act = ring + 3 * SLOT;"),
        ("""  Acc acc;
  const float* h = X;""", """  int ql = 0, qc = 0, qs = 0, slot = 0;
  auto load_next = [&]() {
    if (ql < L - 1) {
      const int M = lay.out[ql], K = lay.in[ql], k0 = qc * KC;
      const float* Wl = W + lay.off[ql];
      float* dst = ring + qs * SLOT;
      const int segs = ((M + 15) & ~15) * (KC / 4);
      for (int s = threadIdx.x; s < segs; s += NT) {
        const int m = s / (KC / 4), kk = (s % (KC / 4)) * 4;
        const bool ok = m < M && k0 + kk < K;
        cp16(dst + m * SW + kk, ok ? Wl + (size_t)m * lay.ldw + k0 + kk : W,
             ok);
      }
      qs = qs + 1 == 3 ? 0 : qs + 1;
      if (++qc * KC >= K) {
        qc = 0;
        ++ql;
      }
    }
    cp_commit();
  };
  load_next();
  load_next();
  Acc acc;
  const float* h = X;"""),
        ("""    tc_product<T, false>(W + lay.off[l], lay.ldw, M, lay.in[l], h, ring,
                         acc);""", """    zero_acc(acc);
    for (int k0 = 0; k0 < lay.in[l]; k0 += KC) {
      cp_wait<1>();
      __syncthreads();
      load_next();
      const float* cur = ring + slot * SLOT;
      slot = slot + 1 == 3 ? 0 : slot + 1;
      const float* xk = h + (size_t)k0 * SA;
      Acc part;
      zero_acc(part);
      mma_chunk<T, KC>(
          part, f, M, [&](int m, int kk) { return cur[m * SW + kk]; },
          [&](int kk, int p) { return xk[kk * SA + p]; });
      add_acc(acc, part);
    }
    __syncthreads();""")]},
}
# #2's wgmma kernels (mlp_train_wgmma.cu), timed at the (bf16, bf16) pair
# they serve. The side arrays' L2 prefetch taken out; one product ahead
# as well as the current one; the side arrays' traffic taken out (constant
# sigmoids and carries: wrong results, the traffic's cost); one wgmma
# chain a contraction (no fresh accumulator a 64-deep chunk); and two more
# costs, below.
WGMMA_SIDE_READS = (
    ("      const float4 sv = *side(l - 1, 0, h, j);\n      const float sg[4]",
     "      const float4 sv = make_float4(0.5f, 0.5f, 0.5f, 0.5f);\n"
     "      const float sg[4]"),
    ("      const float4 cv = *cp, sv = *side(l, 0, h, j);",
     "      const float4 cv = make_float4(0.5f, 0.5f, 0.5f, 0.5f), sv = cv;"),
    ("      const float4 sv = *side(l - 1, 0, h, j), hv = *side(l - 1, 1, h, "
     "j);", "      const float4 sv = make_float4(0.5f, 0.5f, 0.5f, 0.5f), "
     "hv = sv;"))
QUERY_EPILOGUE_MATH = (
    "          sig_softplus100_approx(acc[4 * j + e] + a.B[f * L + l], sig,\n"
    "                                 act);")
NO_PROMOTION_ADD = ("    for (int i = 0; i < 64; ++i) acc[i] += part[i];\n",
                    "    for (int i = 0; i < 64; ++i) part[i] = 0.f;\n")
WGMMA_SIDE_WRITES = tuple(
    (f"      {lhs} = make_float4({v}[0], {v}[1], {v}[2], {v}[3]);",
     f"      if ({v}[0] == 12345.f) {lhs} = make_float4({v}[0], {v}[1], "
     f"{v}[2], {v}[3]);")
    for lhs, v in (("*side(l, 0, h, j)", "sg"), ("*side(l - 1, 1, h, j)", "ch"),
                   ("*cp", "sh")))
WGMMA_PREFETCHES = (
    ("    prefetch(l - 1, 0);\n    for (int h = 0; h < halves(N); ++h) {\n"
     "      product_half<1>(acc, part, smem_u32(cur), ring_addr, K, stage, "
     "phase,\n                      full, empty);\n      epi_grad(l, h);",
     "    prefetch(l - 2, 0);"),
    ("    prefetch(l, 0);\n    prefetch(l, 1);\n",
     "    prefetch(l + 1, 0);\n    prefetch(l + 1, 1);\n"),
    ("    prefetch(l - 1, 0);\n    prefetch(l - 1, 1);\n",
     "    prefetch(l - 2, 0);\n    prefetch(l - 2, 1);\n"))
ABLATIONS.update({
    "wgmma_no_prefetch": {"mlp_train_wgmma.cu": [
        (old, old.replace("    prefetch(l - 1, 0);\n", "") if "epi_grad" in old
         else "") for old, _ in WGMMA_PREFETCHES]},
    "wgmma_prefetch_ahead": {"mlp_train_wgmma.cu": [
        ("    if (t == 0)\n      l2_prefetch(",
         "    if (t == 0 && l >= 0 && l < L - 1)\n      l2_prefetch(")] + [
        (old, old + "\n" + extra if "epi_grad" not in old
         else old.replace("    prefetch(l - 1, 0);\n",
                          "    prefetch(l - 1, 0);\n" + extra + "\n"))
        for old, extra in WGMMA_PREFETCHES]},
    "wgmma_no_side": {"mlp_train_wgmma.cu": list(WGMMA_SIDE_READS
                                                 + WGMMA_SIDE_WRITES)},
    # the forward epilogue's softplus and sigmoid replaced by a scale and a
    # constant (wrong results: what the transcendental math costs)
    "wgmma_no_epilogue_math": {"mlp_train_wgmma.cu": [(
        "          sig_softplus100(acc[4 * j + e] + a.B[f * L + l], sig, act);",
        "          sig = 0.5f;\n"
        "          act = (acc[4 * j + e] + a.B[f * L + l]) * 0.01f;")]},
    # no TMA store of the weight-gradient factors (the GEMM then reads
    # stale scratch: what the factors' 2 GB of writes cost)
    "wgmma_no_factor_stores": {"mlp_train_wgmma.cu": [(
        "        tma_store(&mf, nxt + b * BOX_BYTES, (int)p0, row + 64 * b);",
        "        if (row < 0)\n"
        "          tma_store(&mf, nxt + b * BOX_BYTES, (int)p0, row + 64 * b);")]},
    # the chain products' (mlp_wgmma.cuh, shared with #1a's wgmma kernel)
    # and the GEMM's (mlp_train_gemm.cuh, shared with the mixed pair's)
    "wgmma_no_promotion": {
        "mlp_wgmma.cuh": [
            ("""      wgmma_m64n128<1, TB>(part, desc_mnmajor(a, s),
                           TB ? desc_mnmajor(b, s) : desc_kmajor(b, s), s);""",
             """      wgmma_m64n128<1, TB>(acc, desc_mnmajor(a, s),
                           TB ? desc_mnmajor(b, s) : desc_kmajor(b, s), 1);"""),
            NO_PROMOTION_ADD],
        "mlp_train_gemm.cuh": [
            ("""      wgmma_m64n128<0, 0>(part, desc_kmajor(b + cw * BOX_BYTES, s),
                          desc_kmajor(b + 2 * BOX_BYTES, s), s);""",
             """      wgmma_m64n128<0, 0>(acc, desc_kmajor(b + cw * BOX_BYTES, s),
                          desc_kmajor(b + 2 * BOX_BYTES, s), 1);"""),
            NO_PROMOTION_ADD]},
})
# #1a's wgmma kernel (mlp_query_wgmma.cu), timed at the bf16 tier it
# serves: the sigmoid side arrays' traffic taken out (no store; constant
# sigmoids read: wrong results, the traffic's cost), their L2 prefetch
# taken out, the forward epilogue's softplus and sigmoid replaced by a
# scale and a constant (wrong results: what the transcendental math
# costs), and that math in its exact fp32 forms.
ABLATIONS.update({
    "query_wgmma_no_side": {"mlp_query_wgmma.cu": [
        ("      if (128 * h + 8 * j < M)\n        side_put(",
         "      if (128 * h + 8 * j < M && sg[0] == 12345.f)\n"
         "        side_put("),
        ("      if (128 * h + 8 * j < c) sv = side_get(side(l - 1), h, j, t);",
         "      if (128 * h + 8 * j < c) sv = make_float4(0.5f, 0.5f, 0.5f, "
         "0.5f);")]},
    "query_wgmma_no_prefetch": {"mlp_query_wgmma.cu": [
        ("    prefetch(l - 1);\n", "")]},
    "query_wgmma_no_epilogue_math": {"mlp_query_wgmma.cu": [(
        QUERY_EPILOGUE_MATH,
        "          sig = 0.5f;\n"
        "          act = (acc[4 * j + e] + a.B[f * L + l]) * 0.01f;")]},
    # the epilogue's softplus and sigmoid from the exact fp32 forms
    # (sig_softplus100: expf, __frcp_rn, log1pf) in place of the special
    # function unit's approximations; and log1pf alone exact
    "query_wgmma_exact_math": {"mlp_query_wgmma.cu": [(
        QUERY_EPILOGUE_MATH, QUERY_EPILOGUE_MATH.replace("_approx(", "("))]},
    "query_wgmma_exact_log1p": {"mlp_query_wgmma.cu": [(
        "          : lg * 0.69314718f;", "          : log1pf(e);")]},
})
# sig_softplus100_approx of mlp_query_wgmma.cu, for the 3xTF32 kernel's
# epilogue ablation
APPROX_MATH = """\
__device__ __forceinline__ void sig_softplus100_approx(float z, float& sig,
                                                       float& sp) {
  const float t = z * 100.f;
  float e, r, lg;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-fabsf(t) * 1.44269504f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(1.f + e));
  const float lp =
      e < 0.015625f
          ? e * (1.f - e * (0.5f - e * (0.33333334f - e * 0.25f)))
          : lg * 0.69314718f;
  sig = (t >= 0.f ? 1.f : e) * r;
  sp = (fmaxf(t, 0.f) + lp) * 0.01f;
}

struct QArgs {"""
TF32_EPILOGUE_MATH = (
    "        sig_softplus100(acc[4 * j + e] + bias, sg[e], act[e]);")
TF32_PASSES = """      wgmma_tf32<NW>(part, al[s], desc_kmajor(bh, s), s);
      wgmma_tf32<NW>(part, ah[s], desc_kmajor(bl, s), 1);
      wgmma_tf32<NW>(part, ah[s], desc_kmajor(bh, s), 1);"""
# #1's 3xTF32 kernel (mlp_query_tf32.cu), timed at that tier: the sigmoid
# side arrays' traffic taken out (no store; constant sigmoids read: wrong
# results, the traffic's cost), their L2 prefetch taken out, the forward
# epilogue's softplus and sigmoid replaced by a scale and a constant (wrong
# results: what the exact fp32 math costs) or by the special function
# unit's approximations (sig_softplus100_approx, the bf16 tier's), one
# wgmma chain a contraction (no fresh accumulator a 32-step chunk), and
# one TF32 pass (hi * hi) in place of three (what two passes cost).
ABLATIONS.update({
    "query_tf32_no_side": {"mlp_query_tf32.cu": [
        ("      if (128 * h + 8 * j < M)\n        side_put(",
         "      if (128 * h + 8 * j < M && sg[0] == 12345.f)\n"
         "        side_put("),
        ("      if (128 * h + 8 * j < c) sv = side_get(side(l - 1), h, j, t);",
         "      if (128 * h + 8 * j < c) sv = make_float4(0.5f, 0.5f, 0.5f, "
         "0.5f);")]},
    "query_tf32_no_prefetch": {"mlp_query_tf32.cu": [
        ("    prefetch(l - 1);\n", "")]},
    "query_tf32_no_epilogue_math": {"mlp_query_tf32.cu": [(
        TF32_EPILOGUE_MATH,
        "        sg[e] = 0.5f;\n"
        "        act[e] = (acc[4 * j + e] + bias) * 0.01f;")]},
    "query_tf32_approx_math": {"mlp_query_tf32.cu": [
        ("struct QArgs {", APPROX_MATH),
        (TF32_EPILOGUE_MATH,
         TF32_EPILOGUE_MATH.replace("100(", "100_approx("))]},
    "query_tf32_no_promotion": {"mlp_query_tf32.cu": [
        (TF32_PASSES, TF32_PASSES.replace("(part,", "(acc,").replace(
            "bh, s), s);", "bh, s), 1);")),
        ("    for (int i2 = 0; i2 < NW / 2; ++i2) acc[i2] += part[i2];\n",
         "")]},
    # the lo boxes not loaded, the hi chunk read in their place (half the
    # weight stream from L2: wrong results, what the stream costs)
    "query_tf32_half_stream": {
        "mlp_query_tf32.cu": [
            ("        mbar_expect_tx(&full[stage], 2 * boxes * T_BOX_BYTES);",
             "        mbar_expect_tx(&full[stage], boxes * T_BOX_BYTES);"),
            ("bl = bh + T_HALF_BYTES;", "bl = bh;")],
        "mlp_tf32.cuh": [
            ("""    tma_load(dst + lo_off + j * T_BOX_BYTES, mp, col, FMAX + row + 64 * j,
             bar);
""", "")]},
    # a 2-stage ring in place of 4 (half the weight chunks in flight)
    "query_tf32_stages2": {"mlp_query_tf32.cu": [
        ("constexpr int T_STAGES = 4;", "constexpr int T_STAGES = 2;")]},
    # A's fragments passed unsplit (hi the fp32 bits, lo 0: wrong results,
    # what the split's integer and float work costs)
    "query_tf32_no_split": {"mlp_tf32.cuh": [(
        """    split3(v0.x, ah[s][0], al[s][0]);
    split3(v1.x, ah[s][1], al[s][1]);
    split3(v0.y, ah[s][2], al[s][2]);
    split3(v1.y, ah[s][3], al[s][3]);""",
        """    ah[s][0] = __float_as_uint(v0.x);
    ah[s][1] = __float_as_uint(v1.x);
    ah[s][2] = __float_as_uint(v0.y);
    ah[s][3] = __float_as_uint(v1.y);
    al[s][0] = al[s][1] = al[s][2] = al[s][3] = 0u;""")]},
    "query_tf32_one_pass": {"mlp_query_tf32.cu": [
        (TF32_PASSES,
         "      wgmma_tf32<NW>(part, ah[s], desc_kmajor(bh, s), s);")]},
})
VALUE_TF32_ONE_TILE = """  for (long long tt = blockIdx.x; tt < a.tiles; tt += gridDim.x) {
    p0 = tt * PW;
    // x = PE(points): layer 0's input, zeros up to its contraction
    fill_x(tile, 0, tl.kf[0], 1.f);
    csync();
    for (int l = 0; l < L - 1; ++l) {
      const int M = lay.out[l], K = tl.kf[l], np = passes(M);
      const bool head = l == L - 2;
      const float scale = lay.skip[l + 1] ? INV_SQRT2 : 1.f;
      float s[2] = {0.f, 0.f};  // the head's dot: this thread's share
      // this consumer's passes (cw, cw + V_CONSUMERS), activated, wait in
      // registers until both consumers have read the whole tile
      float held[V_HELD][V_NP][32];
#pragma unroll
      for (int kk = 0; kk < V_HELD; ++kk) {
        const int k = cw + V_CONSUMERS * kk;
        if (k < np) {
          product(tile, K, pass_entries(M, k));
          activate(l, k, M, scale);
#pragma unroll
          for (int n = 0; n < V_NP; ++n)
#pragma unroll
            for (int r = 0; r < 32; ++r) held[kk][n][r] = acc[n][r];
        }
      }
      if (!head) csync();
#pragma unroll
      for (int kk = 0; kk < V_HELD; ++kk) {
        const int k = cw + V_CONSUMERS * kk;
        if (k >= np) continue;
#pragma unroll
        for (int n = 0; n < V_NP; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int f0 = 64 * (V_NP * k + n) + 8 * j + 2 * q;
            const float* v = held[kk][n] + 4 * j;
            if (head) {
              // the last hidden layer's outputs: their share of w . u
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (f0 + (e & 1) < M)
                  s[e >> 1] = fmaf(whead[f0 + (e & 1)], v[e], s[e >> 1]);
            } else {
              *reinterpret_cast<float2*>(tile_ptr(tile, p, f0)) =
                  make_float2(v[0], v[1]);
              *reinterpret_cast<float2*>(tile_ptr(tile, p + 8, f0)) =
                  make_float2(v[2], v[3]);
            }
          }
      }
      if (head) {
        // the quad's shares, then the consumer's sum for points p, p + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
          if (q == 0) red[cw * PW + p + 8 * h] = s[h];
        }
      } else if (lay.skip[l + 1]) {
        // at a skip the features from out_l on are x / sqrt2, once every
        // pass has written its outputs
        csync();
        fill_x(tile, M, tl.kf[l + 1], INV_SQRT2);
      }
      csync();
    }
"""
VALUE_TF32_TWO_TILES = """  unsigned char* const X = tile;
  unsigned char* const Y = tile + T_TILE_BYTES;
  for (long long tt = blockIdx.x; tt < a.tiles; tt += gridDim.x) {
    p0 = tt * PW;
    // x = PE(points): layer 0's input, zeros up to its contraction
    fill_x(X, 0, tl.kf[0], 1.f);
    csync();
    for (int l = 0; l < L - 1; ++l) {
      unsigned char* const in = l & 1 ? Y : X;
      unsigned char* const out = l & 1 ? X : Y;
      const int M = lay.out[l], K = tl.kf[l], np = passes(M);
      const bool head = l == L - 2;
      const float scale = lay.skip[l + 1] ? INV_SQRT2 : 1.f;
      float s[2] = {0.f, 0.f};  // the head's dot: this thread's share
      for (int k = cw; k < np; k += V_CONSUMERS) {
        product(in, K, pass_entries(M, k));
        activate(l, k, M, scale);
#pragma unroll
        for (int n = 0; n < V_NP; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int f0 = 64 * (V_NP * k + n) + 8 * j + 2 * q;
            if (head) {
              // the last hidden layer's outputs: their share of w . u
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (f0 + (e & 1) < M)
                  s[e >> 1] = fmaf(whead[f0 + (e & 1)], acc[n][4 * j + e],
                                   s[e >> 1]);
            } else {
              *reinterpret_cast<float2*>(tile_ptr(out, p, f0)) =
                  make_float2(acc[n][4 * j], acc[n][4 * j + 1]);
              *reinterpret_cast<float2*>(tile_ptr(out, p + 8, f0)) =
                  make_float2(acc[n][4 * j + 2], acc[n][4 * j + 3]);
            }
          }
      }
      if (head) {
        // the quad's shares, then the consumer's sum for points p, p + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
          if (q == 0) red[cw * PW + p + 8 * h] = s[h];
        }
      } else if (lay.skip[l + 1]) {
        // at a skip the features from out_l on are x / sqrt2, once every
        // pass has written its outputs
        csync();
        fill_x(out, M, tl.kf[l + 1], INV_SQRT2);
      }
      csync();
    }
"""
VALUE_TF32_WGMMAS = """          wgmma_tf32_n64(part[e], al[s], desc_kmajor(bh, s), s);
          wgmma_tf32_n64(part[e], ah[s], desc_kmajor(bl, s), 1);
          wgmma_tf32_n64(part[e], ah[s], desc_kmajor(bh, s), 1);"""
# #3's 3xTF32 kernel (mlp_value_tf32.cu), timed at that tier at a 128^3
# grid pass: a layer's input and output in two tiles, each pass's outputs
# stored as soon as they are ready (in place of one tile, over which the
# held passes go once both consumers have read it), the second consumer
# held back at each layer until the first
# has run its first pass's products (ping-pong: one consumer's epilogue
# beside the other's products, their products seldom together), the next
# chunk's A split after the current chunk's products in place of beside
# them (one set of A fragments), the epilogue's exact softplus replaced by
# a scale (wrong results: what the exact fp32 math costs) or by the
# special function unit's forms, a 2-stage ring a consumer in place of 3,
# one wgmma chain a contraction (no fresh accumulator a 32-step chunk),
# passes of 128 outputs (two m64n64 products a pass: 64 more accumulator
# registers, half the A loads) in place of 64, and the lo boxes not
# loaded, the hi box read in their place (half the weight stream from L2:
# wrong results, what the stream costs).
ABLATIONS.update({
    "value_tf32_two_tiles": {"mlp_value_tf32.cu": [
        ("                       T_TILE_BYTES + V_CONSUMERS * PW * 4 +",
         "                       2 * T_TILE_BYTES + V_CONSUMERS * PW * 4 +"),
        ("float* red = reinterpret_cast<float*>(tile + T_TILE_BYTES);",
         "float* red = reinterpret_cast<float*>(tile + 2 * T_TILE_BYTES);"),
        (VALUE_TF32_ONE_TILE, VALUE_TF32_TWO_TILES)]},
    "value_tf32_pingpong": {"mlp_value_tf32.cu": [
        ("      float s[2] = {0.f, 0.f};  // the head's dot: this thread's share",
         "      float s[2] = {0.f, 0.f};  // the head's dot: this thread's share\n"
         "      if (cw == 1) named_sync(2, V_CONSUMERS * WG);"),
        ("          product(tile, K, pass_entries(M, k));",
         "          product(tile, K, pass_entries(M, k));\n"
         "        if (k == 0) asm volatile(\"bar.arrive 2, %0;\" :: "
         "\"r\"(V_CONSUMERS * WG) : \"memory\");")]},
    "value_tf32_no_prefetch": {"mlp_value_tf32.cu": [(
        """    split_a_chunk(in, p, q, 0, xh, xl);
    for (int c = 0; c < nc; c += 2) {
      chunk(in, ne, xh, xl, c + 1, nc, yh, yl);
      if (c + 1 < nc) chunk(in, ne, yh, yl, c + 2, nc, xh, xl);
    }""",
        """    for (int c = 0; c < nc; ++c) {
      split_a_chunk(in, p, q, c, xh, xl);
      chunk(in, ne, xh, xl, nc, nc, yh, yl);
    }""")]},
    "value_tf32_no_epilogue_math": {"mlp_value_tf32.cu": [(
        "softplus100(acc[n][4 * j + e] + bias) * scale;",
        "(acc[n][4 * j + e] + bias) * 0.01f * scale;")]},
    "value_tf32_approx_math": {"mlp_value_tf32.cu": [
        ("struct VArgs {", """\
__device__ __forceinline__ float softplus100_approx(float z) {
  const float t = z * 100.f;
  float e, lg;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-fabsf(t) * 1.44269504f));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(1.f + e));
  const float lp =
      e < 0.015625f
          ? e * (1.f - e * (0.5f - e * (0.33333334f - e * 0.25f)))
          : lg * 0.69314718f;
  return (fmaxf(t, 0.f) + lp) * 0.01f;
}

struct VArgs {"""),
        ("softplus100(acc[n][4 * j + e] + bias)",
         "softplus100_approx(acc[n][4 * j + e] + bias)")]},
    "value_tf32_stages2": {"mlp_value_tf32.cu": [
        ("constexpr int V_STAGES = 3;", "constexpr int V_STAGES = 2;")]},
    "value_tf32_no_promotion": {"mlp_value_tf32.cu": [
        (VALUE_TF32_WGMMAS, VALUE_TF32_WGMMAS.replace(
            "(part[e],", "(acc[e],").replace("bh, s), s);", "bh, s), 1);")),
        ("""#pragma unroll
    for (int e = 0; e < V_NP; ++e)
      if (V_NP == 1 || e < ne)
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[e][r] += part[e][r];
""", "")]},
    "value_tf32_halves": {"mlp_value_tf32.cu": [
        ("constexpr int V_NP = 1;", "constexpr int V_NP = 2;")]},
    "value_tf32_half_stream": {"mlp_value_tf32.cu": [
        ("            mbar_expect_tx(&full[stage], V_ENTRY_BYTES);",
         "            mbar_expect_tx(&full[stage], T_BOX_BYTES);"),
        ("""            tma_entry(ring + stage * V_ENTRY_BYTES, mp, tl.offf[l] + 32 * c,
                      64 * (V_NP * k + e), 1, T_BOX_BYTES, &full[stage]);""",
         """            tma_load(ring + stage * V_ENTRY_BYTES, mp, tl.offf[l] + 32 * c,
                     64 * (V_NP * k + e), &full[stage]);"""),
        ("bl = bh + T_BOX_BYTES;", "bl = bh;")]},
})
# The libraries an ablation is timed on where not every library its
# patches reach: p128's tile does not fit the training kernels' shared
# memory; the patches of mlp_tf32.cuh are #1's ablations.
# #2's kernels at the pairs with a 3xTF32 tier (mlp_train_tf32.cu), timed
# at the 3xTF32 and mixed pairs: the weight-gradient factors not stored
# (the GEMM then reads stale scratch: what the factor stores cost), the
# side arrays' traffic taken out (no store; constant sigmoids, carries and
# s-hats read), their L2 prefetch taken out, and the forward epilogue's
# softplus and sigmoid replaced by a scale and a constant (each but the
# prefetch: wrong results by design, what that work costs), and the factor
# stores' addresses as 32-bit offsets (the same results).
TRAIN_TF32_SIDE = tuple(
    (f"{lhs} = side_get(side({arg}), h, j, t);",
     f"{lhs} = make_float4(0.5f, 0.5f, 0.5f, 0.5f);")
    for lhs, arg in (("if (live) sv", "l - 1, 0"), ("cv", "l, 1"),
                     ("sv", "l, 0"), ("sv", "l - 1, 0"), ("hv", "l - 1, 1")))
ABLATIONS.update({
    "train_tf32_no_factor_stores": {"mlp_train_tf32.cu": [(
        '::"l"(p), "f"(v), "r"((int)keep));', '::"l"(p), "f"(v), "r"(0));')]},
    "train_tf32_no_side": {"mlp_train_tf32.cu": list(TRAIN_TF32_SIDE) + [(
        "        side_put(side(", "        if (lane > 32) side_put(side(")]},
    "train_tf32_no_prefetch": {"mlp_train_tf32.cu": [(
        "    if (t == 0)\n      l2_prefetch(", "    if (t > WG)\n      l2_prefetch(")]},
    "train_tf32_no_epilogue_math": {"mlp_train_tf32.cu": [(
        "        sig_softplus100(acc[4 * j + e] + bias, sg[e], act[e]);",
        "        sg[e] = 0.5f;\n"
        "        act[e] = (acc[4 * j + e] + bias) * 0.01f;")]},
    # the factor stores addressed by a 32-bit offset from a 64-bit row
    # base in place of a 64-bit address each (fewer live 64-bit values in
    # the epilogues; same results)
    "train_tf32_offsets32": {"mlp_train_tf32.cu": [(
        """    auto* r0 = fac + (size_t)(row + f0) * ld + pr;
    st_if(r0, v[0], keep0);
    st_if(r0 + 8, v[2], keep0);
    st_if(r0 + ld, v[1], keep1);
    st_if(r0 + ld + 8, v[3], keep1);""",
        """    auto* base = fac + (size_t)row * ld;
    const unsigned o = (unsigned)f0 * (unsigned)ld + (unsigned)pr;
    st_if(base + o, v[0], keep0);
    st_if(base + (o + 8u), v[2], keep0);
    st_if(base + (o + (unsigned)ld), v[1], keep1);
    st_if(base + (o + (unsigned)ld + 8u), v[3], keep1);""")]},
})
# #3's bf16 kernel (mlp_value_wgmma.cu), timed at that tier at a 128^3 grid
# pass: as built alone (the reference of the others), the consumers taking
# turns at the tensor cores (ping-pong: each 128-wide half's products
# behind a named barrier that the other consumer opens when its own are
# done, so one's epilogue runs beside the other's products), a 5-stage ring
# in place of 4 (the engine's STAGES, timed on this library alone), the
# special function unit's softplus replaced by the exact fp32 form, one
# wgmma chain a contraction (no fresh accumulator a 64-deep chunk), and,
# each with wrong results by design (what that work costs): the softplus
# replaced by a scale, the PE's sin and cos by their fast forms, and one
# 64 x 64 box of a stage's two loaded (half the weight stream from L2; the
# other box's rows read stale).
VALUE_WGMMA_SOFTPLUS = "  return (fmaxf(u, 0.f) + lg) * c;"
VALUE_WGMMA_TILE_LOOP = (
    "  for (long long tt = blockIdx.x; tt < a.pairs; tt += gridDim.x) {\n")
VALUE_WGMMA_END = ("        a.udf[p0 + p + 8 * k] = u / lay.scale;\n"
                   "      }\n    }\n  }\n")
ABLATIONS.update({
    "value_wgmma_as_built": {},
    "value_wgmma_pingpong": {"mlp_value_wgmma.cu": [
        ("  auto wg_sync = [&] { named_sync(1 + wg, WG); };\n",
         "  auto wg_sync = [&] { named_sync(1 + wg, WG); };\n"
         "  auto take_turn = [&] { named_sync(3 + wg, 2 * WG); };\n"
         "  auto pass_turn = [&] {\n"
         "    asm volatile(\"bar.arrive %0, %1;\\n\" ::\"r\"(4 - wg), "
         "\"r\"(2 * WG) : \"memory\");\n"
         "  };\n"),
        (VALUE_WGMMA_TILE_LOOP,
         "  if (wg == 1) pass_turn();\n" + VALUE_WGMMA_TILE_LOOP),
        ("        half_product(acc, part, smem_u32(cur), ring_addr, K, stage, "
         "phase,\n                     full, empty);\n",
         "        take_turn();\n"
         "        half_product(acc, part, smem_u32(cur), ring_addr, K, stage, "
         "phase,\n                     full, empty);\n"
         "        pass_turn();\n"),
        (VALUE_WGMMA_END + "}",
         VALUE_WGMMA_END + "  if (wg == 0) take_turn();\n}")]},
    "value_wgmma_stages5": {"mlp_wgmma.cuh": [
        ("constexpr int STAGES = 4;", "constexpr int STAGES = 5;")]},
    "value_wgmma_exact_math": {"mlp_value_wgmma.cu": [(
        VALUE_WGMMA_SOFTPLUS,
        "  const float t = u * 0.69314718f;  // 100 z\n"
        "  return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) * (c * "
        "1.44269504f);")]},
    "value_wgmma_no_promotion": {"mlp_value_wgmma.cu": [
        ("                                           uint64_t* empty) {\n"
         "  mbar_wait(&full[stage], phase);",
         "                                           uint64_t* empty,\n"
         "                                           bool keep = false) {\n"
         "  mbar_wait(&full[stage], phase);"),
        ("desc_kmajor(b, s), s);", "desc_kmajor(b, s), s || keep);"),
        ("    chunk_into(part, a_addr + c * BOX_BYTES, ring, stage, phase, "
         "full, empty);\n#pragma unroll\n"
         "    for (int i = 0; i < 64; ++i) acc[i] += part[i];",
         "    chunk_into(acc, a_addr + c * BOX_BYTES, ring, stage, phase, "
         "full, empty,\n               true);")]},
    "value_wgmma_no_epilogue_math": {"mlp_value_wgmma.cu": [
        (VALUE_WGMMA_SOFTPLUS, "  return u * c;")]},
    "value_wgmma_fast_pe": {"mlp_value_wgmma.cu": [
        ("          sincosf(a.pts", "          __sincosf(a.pts")]},
    "value_wgmma_half_stream": {"mlp_value_wgmma.cu": [
        ("          mbar_expect_tx(&full[stage], STAGE_BYTES);",
         "          mbar_expect_tx(&full[stage], BOX_BYTES);"),
        ("          for (int j = 0; j < 2; ++j)\n            tma_load(",
         "          for (int j = 0; j < 1; ++j)\n            tma_load(")]},
})
TIMED = {"p128": ("mlp_value",), "query_tf32_no_split": ("mlp_query_tf32",),
         "query_tf32_half_stream": ("mlp_query_tf32",),
         "value_wgmma_as_built": ("mlp_value_wgmma",),
         "value_wgmma_stages5": ("mlp_value_wgmma",)}


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


def libraries(name: str, tree: str = "") -> tuple:
    """The libraries an ablation's patches reach (every one for as_built
    and for a patch of a shared header), or those of SOURCES a checkout's
    tree holds."""
    from emap_tpu_torch.kernels import build

    if name not in ABLATIONS:
        return tuple(lib for lib in build.SOURCES
                     if os.path.exists(os.path.join(tree, f"{lib}.cu")))
    if name in TIMED:
        return TIMED[name]
    files = ABLATIONS[name]
    if not files or any(fn.endswith(".cuh") for fn in files):
        return build.SOURCES
    return tuple(lib for lib in build.SOURCES if f"{lib}.cu" in files)


def parse_args(argv) -> tuple:
    """(ablation names, {variant name: csrc directory of a checkout})."""
    names, trees = [], {}
    it = iter(argv)
    for arg in it:
        if arg == "--tree":
            name, _, root = next(it).partition("=")
            trees[name] = os.path.join(os.path.abspath(root), "emap_tpu_torch",
                                       "csrc")
            if not os.path.isdir(trees[name]):
                raise SystemExit(f"torch_kernel_ablation: no {trees[name]}")
        else:
            names.append(arg)
    return names or ([] if trees else list(ABLATIONS)), trees


def main(argv) -> int:
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
    grid_n = 128 ** 3
    xg = torch.zeros(8, grid_n, device="cuda")
    xg[:3] = torch.rand(3, grid_n, generator=g, device="cuda") * 2 - 1
    u_p, g_p = tq.value_and_grad_plain(x, w, b, cfg)
    bwd_p = tq.unpack_weights(*tt.train_bwd_plain(x, w, b, ub, gb, cfg), cfg)
    bf16 = dataclasses.replace(cfg, precision="default")
    bwd_bf = tq.unpack_weights(*tt.train_bwd_plain(x, w, b, ub, gb, bf16),
                               cfg)
    mixed = dataclasses.replace(cfg, bwd_precision="default")
    bwd_mx = tq.unpack_weights(*tt.train_bwd_plain(x, w, b, ub, gb, mixed),
                               cfg)
    ug_p = tq.value_plain(xg, w, b, cfg)
    ug_bf = tq.value_plain(xg, w, b, bf16)
    q_bf = tq.value_and_grad_plain(x, w, b, bf16)
    names, other = parse_args(argv)

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

    def launch_ms(fn) -> dict:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            m = re.search(r"(\w+_kernel)[<(]", e.key)
            if m:
                parts[m.group(1)] = getattr(e, "device_time_total",
                                            0.0) / 1e3
        return parts

    first = {}  # (variant, kernel): the outputs of its first round

    def same(name, kernel, out) -> str:
        """Whether `out` equals as_built's, bit for bit."""
        first.setdefault((name, kernel), out)
        want = first.get(("as_built", kernel))
        if want is None or name == "as_built":
            return ""
        return (f", bit-identical to as_built: "
                f"{all(torch.equal(a, c) for a, c in zip(out, want))}")

    def legacy_wgmma(tree):
        """Another checkout's #1a bf16 library from before its sigmoid
        residuals took a width (no bf16_side argument): bound with its own
        interface, fp32 residuals."""
        with open(os.path.join(tree, "mlp_query_wgmma.cu")) as f:
            if "bf16_side" in f.read():
                return None
        import ctypes

        def launch(x_T, w_pack, b_pack, cfg, n, f32_residuals):
            lib = build.load("mlp_query_wgmma")
            vp = ctypes.c_void_p
            lib.emap_mlp_query_wgmma.argtypes = [
                vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp,
                ctypes.c_float, ctypes.c_int, vp]
            plan = tq.query_wgmma_plan(cfg, n)
            udf = torch.empty(n, device="cuda")
            grad = torch.empty(8, n, device="cuda")
            wb = torch.empty(plan["wb"], device="cuda", dtype=torch.bfloat16)
            side = torch.empty(plan["side"], device="cuda")
            err = lib.emap_mlp_query_wgmma(
                x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(),
                udf.data_ptr(), grad.data_ptr(), wb.data_ptr(),
                side.data_ptr(), n, tq.kernel_layout(cfg).ctypes.data,
                float(cfg.scale), 1, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"mlp_query_wgmma: CUDA error {err}")
            return udf, grad, {"wb": wb.view(256, -1), "side": side}
        return launch

    launch_wgmma = tq._launch_wgmma
    with tempfile.TemporaryDirectory() as root:
        trees = {name: patched_tree(root, name) for name in names}
        trees.update(other)
        for name, tree in trees.items():
            build.CSRC = tree
            build.build_all(libraries(name, tree))
            for lib in libraries(name, tree):
                for line in build.build_log(lib).splitlines():
                    if "registers" in line or "spill" in line:
                        print(f"ptxas {name} {lib}: {line.strip()}",
                              flush=True)
        for rnd in range(2):
            # in turns: the second round runs the variants in reverse
            order = list(trees.items())
            for name, tree in order if rnd == 0 else order[::-1]:
                build.CSRC = tree
                build._loaded.clear()
                tq._launch_wgmma = legacy_wgmma(tree) or launch_wgmma
                libs = libraries(name, tree)
                if "mlp_query" in libs:
                    u, gr = tq.value_and_grad_mma_sync(x, w, b, cfg)
                    fwd_ms = ms(lambda: tq.value_and_grad_mma_sync(x, w, b,
                                                                   cfg))
                    print(f"round {rnd} {name:20s} #1a mma.sync {fwd_ms:8.3f} "
                          f"ms  max rel err udf {rel(u, u_p):.2e} grad "
                          f"{rel(gr, g_p):.2e}{same(name, '1a', (u, gr))}",
                          flush=True)
                if "mlp_query_tf32" in libs:
                    for f32 in (True, False):
                        def run(f32=f32):
                            return tq.value_and_grad_tf32_parts(
                                x, w, b, cfg, f32_residuals=f32)
                        parts = run()
                        res = (None if f32 else tq.side_residuals(
                            parts["side"], cfg, n))
                        up, gp = (u_p, g_p) if f32 else \
                            tq.value_and_grad_plain(x, w, b, cfg,
                                                    residuals=res)
                        out = (parts["udf"], parts["grad"])
                        worst = max(rel(out[0], up), rel(out[1], gp))
                        mean = max(float((a - c).abs().mean()
                                         / (c.abs().max() + 1e-30))
                                   for a, c in zip(out, (up, gp)))
                        fwd_ms = ms(run)
                        lp = launch_ms(run)
                        tag = "fp32" if f32 else "bf16"
                        print(f"round {rnd} {name:20s} #1 3xTF32 wgmma, {tag} "
                              f"residuals {fwd_ms:8.3f} ms (pack "
                              f"{lp.get('pack_tf32_kernel', 0.0):.3f}, query "
                              f"{lp.get('query_tf32_kernel', 0.0):.3f})  max "
                              f"rel err udf/grad {worst:.2e}, mean "
                              f"{mean:.2e}{same(name, f'1 tf32 {tag}', out)}",
                              flush=True)
                if "mlp_query_wgmma" in libs:
                    out = tq.value_and_grad(x, w, b, bf16)
                    worst = max(rel(a, c) for a, c in zip(out, q_bf))
                    mean = max(float((a - c).abs().mean()
                                     / (c.abs().max() + 1e-30))
                               for a, c in zip(out, q_bf))
                    fwd_ms = ms(lambda: tq.value_and_grad(x, w, b, bf16))
                    parts = launch_ms(lambda: tq.value_and_grad(x, w, b,
                                                                bf16))
                    print(f"round {rnd} {name:20s} #1a bf16 wgmma "
                          f"{fwd_ms:8.3f} ms (pack "
                          f"{parts.get('pack_kernel', 0.0):.3f}, query "
                          f"{parts.get('query_kernel', 0.0):.3f})  max rel "
                          f"err udf/grad {worst:.2e}, mean {mean:.2e}"
                          f"{same(name, '1a bf16', out)}", flush=True)
                if "mlp_train" in libs:
                    for pair, c, want_p in (("3xtf32", cfg, bwd_p),
                                            ("3xtf32+bf16", mixed, bwd_mx)):
                        out = tt.train_bwd_mma_sync(x, w, b, ub, gb, c)
                        bwd = tq.unpack_weights(*out, cfg)
                        worst = max(rel(a, e) for got, want in zip(bwd, want_p)
                                    for a, e in zip(got, want))
                        bwd_ms = ms(lambda: tt.train_bwd_mma_sync(
                            x, w, b, ub, gb, c))
                        parts = launch_ms(lambda: tt.train_bwd_mma_sync(
                            x, w, b, ub, gb, c))
                        tag = "" if pair == "3xtf32" else " " + pair
                        print(f"round {rnd} {name:20s} #2{tag} mma.sync "
                              f"{bwd_ms:8.3f} ms (per_point "
                              f"{parts.get('per_point_kernel', 0.0):.3f}, "
                              f"wbar_partials "
                              f"{parts.get('wbar_partials_kernel', 0.0):.3f}, "
                              f"reduce "
                              f"{parts.get('reduce_partials_kernel', 0.0):.3f})"
                              f"  max rel err wbar {worst:.2e}"
                              f"{same(name, '2 mma.sync' + tag, out)}",
                              flush=True)
                if "mlp_train_tf32" in libs:
                    for pair, c, want_p in (("3xtf32", cfg, bwd_p),
                                            ("3xtf32+bf16", mixed, bwd_mx)):
                        out = tt.train_bwd(x, w, b, ub, gb, c)
                        bwd = tq.unpack_weights(*out, cfg)
                        worst = max(rel(a, e) for got, want in zip(bwd, want_p)
                                    for a, e in zip(got, want))
                        bwd_ms = ms(lambda: tt.train_bwd(x, w, b, ub, gb, c))
                        parts = launch_ms(lambda: tt.train_bwd(x, w, b, ub,
                                                               gb, c))
                        gemm = parts.get("wbar_tf32_kernel",
                                         parts.get("wbar_kernel", 0.0))
                        print(f"round {rnd} {name:20s} #2 {pair} wgmma "
                              f"{bwd_ms:8.3f} ms (per_point "
                              f"{parts.get('train_tf32_kernel', 0.0):.3f}, "
                              f"wbar {gemm:.3f}, reduce "
                              f"{parts.get('reduce_kernel', 0.0):.3f}, packs "
                              f"{parts.get('pack_tf32_kernel', 0.0):.3f} / "
                              f"{parts.get('pack_kernel', 0.0):.3f})  max rel "
                              f"err wbar {worst:.2e}"
                              f"{same(name, '2 ' + pair, out)}", flush=True)
                if "mlp_train_wgmma" in libs:
                    out = tt.train_bwd(x, w, b, ub, gb, bf16)
                    bwd = tq.unpack_weights(*out, cfg)
                    worst = max(rel(a, c) for got, want in zip(bwd, bwd_bf)
                                for a, c in zip(got, want))
                    mean = max(float((a - c).abs().mean()
                                     / (c.abs().max() + 1e-30))
                               for got, want in zip(bwd, bwd_bf)
                               for a, c in zip(got, want))
                    bwd_ms = ms(lambda: tt.train_bwd(x, w, b, ub, gb, bf16))
                    parts = launch_ms(lambda: tt.train_bwd(x, w, b, ub, gb,
                                                           bf16))
                    print(f"round {rnd} {name:20s} #2 bf16 wgmma {bwd_ms:8.3f} "
                          f"ms (per_point "
                          f"{parts.get('per_point_kernel', 0.0):.3f}, wbar "
                          f"{parts.get('wbar_kernel', 0.0):.3f})  max rel "
                          f"err wbar {worst:.2e}, mean {mean:.2e}"
                          f"{same(name, '2 bf16', out)}", flush=True)
                if "mlp_value" in libs:
                    ug = tq.value_mma_sync(xg, w, b, cfg)
                    again = torch.equal(ug, tq.value_mma_sync(xg, w, b, cfg))
                    val_ms = ms(lambda: tq.value_mma_sync(xg, w, b, cfg))
                    print(f"round {rnd} {name:20s} #3 mma.sync {val_ms:8.3f} "
                          f"ms  max rel err udf {rel(ug, ug_p):.2e}, two "
                          f"launches bit-identical: {again}"
                          f"{same(name, '3', (ug,))}", flush=True)
                if "mlp_value_tf32" in libs:
                    ug = tq.value(xg, w, b, cfg)
                    again = torch.equal(ug, tq.value(xg, w, b, cfg))
                    val_ms = ms(lambda: tq.value(xg, w, b, cfg))
                    lp = launch_ms(lambda: tq.value(xg, w, b, cfg))
                    mean = float((ug - ug_p).abs().mean()
                                 / (ug_p.abs().max() + 1e-30))
                    print(f"round {rnd} {name:20s} #3 3xTF32 wgmma "
                          f"{val_ms:8.3f} ms (pack "
                          f"{lp.get('pack_tf32_kernel', 0.0):.3f}, value "
                          f"{lp.get('value_tf32_kernel', 0.0):.3f})  max rel "
                          f"err udf {rel(ug, ug_p):.2e}, mean {mean:.2e}, two "
                          f"launches bit-identical: {again}"
                          f"{same(name, '3 tf32', (ug,))}", flush=True)
                if "mlp_value_wgmma" in libs:
                    ug = tq.value(xg, w, b, bf16)
                    again = torch.equal(ug, tq.value(xg, w, b, bf16))
                    val_ms = ms(lambda: tq.value(xg, w, b, bf16))
                    lp = launch_ms(lambda: tq.value(xg, w, b, bf16))
                    mean = float((ug - ug_bf).abs().mean()
                                 / (ug_bf.abs().max() + 1e-30))
                    print(f"round {rnd} {name:20s} #3 bf16 wgmma "
                          f"{val_ms:8.3f} ms (pack "
                          f"{lp.get('pack_kernel', 0.0):.3f}, value "
                          f"{lp.get('value_wgmma_kernel', 0.0):.3f})  max "
                          f"rel err udf {rel(ug, ug_bf):.2e}, mean "
                          f"{mean:.2e}, two launches bit-identical: {again}"
                          f"{same(name, '3 bf16', (ug,))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
