// Fused UDF field query: value and spatial gradient, on the tensor cores
// with mma.sync: the first design of emap_tpu/kernels/mlp_query.py::
// _pallas_value_and_grad (fuse_pe=True, fp32 sigmoid residuals), at both
// tiers. No path runs it: mlp_query_wgmma.cu (bf16) and mlp_query_tf32.cu
// (3xTF32) replaced it; kernels/mlp_query.py::value_and_grad_mma_sync
// times it beside them.
//
// Computes, per point: the in-kernel PE encode, 9 linears with
// softplus(100 z)/100 (skip concat scaled by 1/sqrt(2)), the abs/square/sdf
// head, then the hand-derived reverse pass for d udf / d x through the
// layers (sigmoid(100 z) residuals) and the PE Jacobian. Out: udf (ld,),
// grad (8, ld) with rows 0-2 live. Every product, forward and reverse, at
// one tier (mlp_mma.cuh: Tier), as the Pallas kernel runs them all at
// cfg.precision.
//
// Bound on the H100: operations. 4 * sum(in_l * out_l) FLOP a point
// (1.84 MFLOP at ABC width) against 68 bytes of input and output a point:
// at the step's 116,736 points >= 3.2 ms at the fp32 FMA peak (67 TFLOP/s)
// and >= 1.3 ms for the three TF32 passes at the tensor-core peak; the BF16
// tier's one pass >= 0.22 ms at 989 TFLOP/s. What holds it above that is
// the work around the mma: the operand splits, the block barriers of one
// 8-warp block per SM, and the softplus/sigmoid epilogues, not the tensor
// cores.
// Design (mlp_mma.cuh): one block of 8 warps walks a 64-point tile through
// the 8 hidden linears and back through their transposes (W_l^T g) as
// mma.sync tile products at the tier; the head's 1-row product is fp32 FMA
// (of bf16-rounded operands at BF16). The tile's activations and reverse
// chain stay in shared memory (186 KB at ABC
// width: the weight ring, the tile, the encoded input and its gradient),
// so the only device scratch is the sigmoid residuals, a side array the
// thread that writes each value reads back: sum_{l<L-1} roundup(out_l, 16)
// rows x N floats (2,000 rows at ABC width, 0.93 GB at the step's N),
// written and read as coalesced float4s.

#include "mlp_mma.cuh"

using namespace emap;

namespace {

struct FwdScratch {
  float* S[MAXL];  // side array (out_l) sigmoid(100 z_l), l < L-1
};

long long fwd_carve(const Layout& lay, float* base, size_t ld,
                    FwdScratch* s) {
  long long row = 0;
  for (int l = 0; l < lay.L - 1; ++l) {
    s->S[l] = base ? base + (size_t)row * ld : nullptr;
    row += side_rows(lay.out[l]);
  }
  return row;
}

template <Tier T>
__global__ void __launch_bounds__(NT, 1)
    mlp_value_and_grad_kernel(const float* pts, const float* __restrict__ W,
                              const float* __restrict__ B, float* udf,
                              float* grad, FwdScratch s, Layout lay,
                              size_t ld) {
  extern __shared__ float4 smem4[];
  const TileSmem ts = tile_smem(lay);
  float* ring = reinterpret_cast<float*>(smem4);
  float* act = ring + RING;               // (ar, SA) activations, then g
  float* X = act + (size_t)ts.ar * SA;     // (xr, SA) encoded input
  float* GIN = X + (size_t)ts.xr * SA;     // (xr, SA) d udf / d encoded x
  float* red = GIN + (size_t)ts.xr * SA;   // (4, P) head partial sums
  float* dyv = red + 4 * P;                // (P) d udf / d y0
  const size_t n0 = (size_t)blockIdx.x * P;
  const int L = lay.L, d0 = lay.d0;
  const Frag f = frag_points();

  for (int i = threadIdx.x; i < ts.ar * SA; i += NT) act[i] = 0.f;
  for (int i = threadIdx.x; i < ts.xr * SA; i += NT) {
    const int r = i / SA, p = i % SA;
    X[i] = r < lay.d0p && p < P ? encode_row(pts, ld, n0 + p, r, lay) : 0.f;
    GIN[i] = 0.f;
  }
  __syncthreads();

  // forward: z_l = W_l u_l + b_l; the tile keeps u_{l+1}, the device
  // scratch sigmoid(100 z_l) for the reverse
  Acc acc;
  const float* h = X;
  for (int l = 0; l < L - 1; ++l) {
    const int M = lay.out[l];
    tc_product<T, false>(W + lay.off[l], lay.ldw, M, lay.in[l], h, ring,
                         acc);
    const bool skip = lay.skip[l + 1] != 0;
    float* S = s.S[l];
    for_groups(M, [&](int mt, int nt) {
      float sig[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = frag_m(f, mt, e);
        sig[e] = 0.f;
        if (m < M) {
          float a;
          sig_softplus100(acc[mt][nt][e] + B[m * L + l], sig[e], a);
          act[m * SA + frag_p(f, nt, e)] = skip ? a * INV_SQRT2 : a;
        }
      }
      *side(S, M, mt, nt) = make_float4(sig[0], sig[1], sig[2], sig[3]);
    });
    if (skip)
      for (int i = threadIdx.x; i < d0 * P; i += NT)
        act[(M + i / P) * SA + i % P] = X[(i / P) * SA + i % P] * INV_SQRT2;
    __syncthreads();
    h = act;
  }
  head_dot<T>(W + lay.off[L - 1], lay.in[L - 1], act, red, dyv);
  if (threadIdx.x < P) {
    const float y0 = dyv[threadIdx.x] + B[L - 1];
    float u, dy;
    if (lay.udf_type == 0) {
      u = fabsf(y0);
      dy = sign_of(y0);
    } else if (lay.udf_type == 1) {
      u = y0 * y0;
      dy = 2.f * y0;
    } else {
      u = y0;
      dy = 1.f;
    }
    udf[n0 + threadIdx.x] = u / lay.scale;
    dyv[threadIdx.x] = dy / lay.scale;
  }
  __syncthreads();

  // reverse: q = W_l^T g (the head's as an outer product); rows below c
  // carry g_{l-1} = q (x 1/sqrt2 at a skip) * sigmoid(100 z_{l-1}); the x
  // rows (skip layer, lin0) add to GIN
  for (int l = L - 1; l >= 0; --l) {
    if (l == L - 1)
      head_outer<T>(W + lay.off[l], lay.in[l], dyv, acc);
    else
      tc_product<T, true>(W + lay.off[l], lay.ldw, lay.in[l], lay.out[l], act,
                          ring, acc);
    const int M = lay.in[l];
    if (l == 0) {
      for_groups(M, [&](int mt, int nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = frag_m(f, mt, e);
          if (m < M) GIN[m * SA + frag_p(f, nt, e)] += acc[mt][nt][e];
        }
      });
    } else {
      const bool skip = lay.skip[l] != 0;
      const int c = lay.out[l - 1];  // rows of g_{l-1}; the x rows follow
      const float* S = s.S[l - 1];
      for_groups(M, [&](int mt, int nt) {
        float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (f.wm * 64 + mt * 16 < c) sv = *side(S, c, mt, nt);
        const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = frag_m(f, mt, e), p = frag_p(f, nt, e);
          const float q = acc[mt][nt][e];
          if (m < c)
            act[m * SA + p] = (skip ? q * INV_SQRT2 : q) * sg[e];
          else if (m < M)
            GIN[(m - c) * SA + p] += q * INV_SQRT2;
        }
      });
    }
    __syncthreads();
  }

  // PE Jacobian: du_j = g_j + sum_k f_k (cos(u_j f_k) gs - sin(u_j f_k) gc)
  const int mr = lay.multires;
  for (int i = threadIdx.x; i < 8 * P; i += NT) {
    const int r = i / P, p = i % P;
    const size_t n = n0 + p;
    float v = 0.f;
    if (r < 3) {
      float du = GIN[r * SA + p];
      for (int k = 0; k < mr; ++k) {
        const float f = (float)(1 << k);
        const float uf = pts[(size_t)r * ld + n] * lay.scale * f;
        const float gs = GIN[(3 + 3 * k + r) * SA + p];
        const float gc = GIN[(3 + 3 * mr + 3 * k + r) * SA + p];
        du = du + f * (cosf(uf) * gs - sinf(uf) * gc);
      }
      v = du * lay.scale;
    }
    grad[(size_t)r * ld + n] = v;
  }
}

template <Tier T>
int launch(const float* pts, const float* W, const float* B, float* udf,
           float* grad, const FwdScratch& s, const Layout& lay, long long n,
           cudaStream_t stream) {
  const size_t bytes = tile_smem(lay).floats() * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_value_and_grad_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  mlp_value_and_grad_kernel<T><<<(unsigned)(n / P), NT, bytes, stream>>>(
      pts, W, B, udf, grad, s, lay, (size_t)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch rows the wrapper allocates (rows x n floats); -1 on a layout the
// kernel does not take.
long long emap_mlp_value_and_grad_scratch_rows(const int* layout) {
  Layout lay;
  if (parse_tc(layout, 1.f, &lay)) return -1;
  FwdScratch s;
  return fwd_carve(lay, nullptr, 0, &s);
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,), grad (8, n); all fp32,
// contiguous, on the device; n a multiple of 64; tier a Tier code. Returns
// cudaErrorInvalidValue on anything else, the CUDA error of the
// shared-memory opt-in, else cudaGetLastError() after the launch.
int emap_mlp_value_and_grad(const float* pts, const float* W, const float* B,
                            float* udf, float* grad, float* scratch,
                            long long n, const int* layout, float scale,
                            int tier, void* stream) {
  Layout lay;
  if (parse_tc(layout, scale, &lay) || n <= 0 || n % P)
    return (int)cudaErrorInvalidValue;
  FwdScratch s;
  fwd_carve(lay, scratch, (size_t)n, &s);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tier == TF32X3)
    return launch<TF32X3>(pts, W, B, udf, grad, s, lay, n, st);
  if (tier == BF16) return launch<BF16>(pts, W, B, udf, grad, s, lay, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
