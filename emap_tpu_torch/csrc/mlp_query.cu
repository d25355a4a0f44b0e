// Fused UDF field query: value and spatial gradient.
//
// Replaces: emap_tpu/kernels/mlp_query.py::_pallas_value_and_grad in both
// its uses: with fuse_pe=True, f32_residuals=True as the forward of the
// training query (emap_tpu/kernels/mlp_train.py::_train_query), and as the
// extraction query of pallas_udf_value_and_grad (PE outside, bf16 residuals
// on the "high" tier there: only to fit VMEM; in fp32 the same function).
// The extraction's calls reach 3,276,800 points, so the wrapper
// (kernels/mlp_query.py::value_and_grad_sliced) launches over slices of at
// most SLICE_CAP points and the scratch stays bounded.
//
// Computes, per point: the in-kernel PE encode, 9 linears with
// softplus(100 z)/100 (skip concat scaled by 1/sqrt(2)), the abs/square/sdf
// head, then the hand-derived reverse pass for d udf / d x through the
// layers (sigmoid(100 z) residuals) and the PE Jacobian. Out: udf (ld,),
// grad (8, ld) with rows 0-2 live.
//
// Bound on the H100: operations. 4 * sum(in_l * out_l) FLOP a point
// (1.84 MFLOP at ABC width) against 68 bytes of input and output a point;
// at the fp32 FMA peak (67 TFLOP/s) the step's 116,736 points take >= 3.2 ms.
// Design: the 8 sigmoid residuals are 8 KB a point, more than shared
// memory holds beyond ~24 points, so one block walks a tile of 64 points
// through every layer and keeps the tile's per-layer vectors in a
// feature-major device scratch buffer (3,138 rows x N floats at ABC width:
// 1.5 GB at the step's N = 116,736, 3.3 GB at a 262,144-point slice); the
// residuals the reverse pass reads back come from device memory, not L2.
// Weights stream from L2 through 16-deep shared-memory stages; each thread
// accumulates a 4 x 4 register tile in fp32 FMA.

#include "mlp_common.cuh"

using namespace emap;

namespace {

struct FwdScratch {
  float* X;        // (d0p) encoded input
  float* A[2];     // (smax) activations, ping-pong
  float* S[MAXL];  // (out_l) sigmoid(100 z_l), l < L-1
  float* G[2];     // (smax) reverse chain, ping-pong
  float* GIN;      // (d0p) gradient w.r.t. the encoded input
  float* DY;       // (1) d udf / d y0
};

long long fwd_carve(const Layout& lay, float* base, size_t ld,
                    FwdScratch* s) {
  long long row = 0;
  auto take = [&](int rows) {
    float* p = base ? base + (size_t)row * ld : nullptr;
    row += rows;
    return p;
  };
  s->X = take(lay.d0p);
  s->A[0] = take(lay.smax);
  s->A[1] = take(lay.smax);
  for (int l = 0; l < lay.L - 1; ++l) s->S[l] = take(lay.out[l]);
  s->G[0] = take(lay.smax);
  s->G[1] = take(lay.smax);
  s->GIN = take(lay.d0p);
  s->DY = take(1);
  return row;
}

__global__ void __launch_bounds__(NT)
    mlp_value_and_grad_kernel(const float* pts, const float* __restrict__ W,
                              const float* __restrict__ B, float* udf,
                              float* grad, FwdScratch s, Layout lay,
                              size_t ld) {
  __shared__ float smem[BK * BMP + BK * P];
  const size_t n0 = (size_t)blockIdx.x * P;
  const int L = lay.L, d0 = lay.d0;

  encode_tile(pts, ld, n0, lay, s.X);
  for (int i = threadIdx.x; i < lay.d0p * P; i += NT)
    s.GIN[(size_t)(i / P) * ld + n0 + i % P] = 0.f;
  __syncthreads();

  // forward: z_l = W_l u_l + b_l, keeping sigmoid(100 z_l) for the reverse
  const float* h = s.X;
  for (int l = 0; l < L; ++l) {
    Rows src{h, lay.in[l], h, 1.f};
    if (l > 0 && lay.skip[l]) src = Rows{h, lay.out[l - 1], s.X, INV_SQRT2};
    const float* Wl = W + lay.off[l];
    if (l < L - 1) {
      float* a_out = s.A[l & 1];
      float* s_out = s.S[l];
      tile_gemm<false>(Wl, lay.ldw, lay.out[l], lay.in[l], src, ld, n0, smem,
                       [&](int m, int p, float acc) {
                         const size_t i = (size_t)m * ld + n0 + p;
                         const float z = acc + B[m * L + l];
                         a_out[i] = softplus100(z);
                         s_out[i] = sigmoid100(z);
                       });
      h = a_out;
    } else {
      tile_gemm<false>(Wl, lay.ldw, 1, lay.in[l], src, ld, n0, smem,
                       [&](int, int p, float acc) {
                         const size_t n = n0 + p;
                         const float y0 = acc + B[l];
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
                         udf[n] = u / lay.scale;
                         s.DY[n] = dy / lay.scale;
                       });
    }
  }

  // reverse: q = W_l^T g; the x rows of q (skip layer, lin0) go to GIN
  const float* g = s.DY;
  for (int l = L - 1; l >= 0; --l) {
    const Rows src{g, lay.out[l], g, 1.f};
    float* gn = s.G[l & 1];
    const int c = lay.in[l] - (lay.skip[l] ? d0 : 0);
    const float* sprev = l > 0 ? s.S[l - 1] : nullptr;
    const bool skip = lay.skip[l] != 0;
    tile_gemm<true>(W + lay.off[l], lay.ldw, lay.in[l], lay.out[l], src, ld,
                    n0, smem, [&](int m, int p, float q) {
                      const size_t n = n0 + p;
                      if (l == 0) {
                        s.GIN[(size_t)m * ld + n] += q;
                      } else if (m < c) {
                        const size_t i = (size_t)m * ld + n;
                        gn[i] = (skip ? q * INV_SQRT2 : q) * sprev[i];
                      } else {
                        s.GIN[(size_t)(m - c) * ld + n] += q * INV_SQRT2;
                      }
                    });
    g = gn;
  }

  // PE Jacobian: du_j = g_j + sum_k f_k (cos(u_j f_k) gs - sin(u_j f_k) gc)
  const int mr = lay.multires;
  for (int i = threadIdx.x; i < 8 * P; i += NT) {
    const int r = i / P;
    const size_t n = n0 + i % P;
    float v = 0.f;
    if (r < 3) {
      float du = s.GIN[(size_t)r * ld + n];
      for (int k = 0; k < mr; ++k) {
        const float f = (float)(1 << k);
        const float uf = pts[(size_t)r * ld + n] * lay.scale * f;
        const float gs = s.GIN[(size_t)(3 + 3 * k + r) * ld + n];
        const float gc = s.GIN[(size_t)(3 + 3 * mr + 3 * k + r) * ld + n];
        du = du + f * (cosf(uf) * gs - sinf(uf) * gc);
      }
      v = du * lay.scale;
    }
    grad[(size_t)r * ld + n] = v;
  }
}

}  // namespace

extern "C" {

// Scratch rows the wrapper allocates (rows x n floats); -1 on a bad layout.
long long emap_mlp_value_and_grad_scratch_rows(const int* layout) {
  Layout lay;
  if (parse_layout(layout, 1.f, &lay)) return -1;
  FwdScratch s;
  return fwd_carve(lay, nullptr, 0, &s);
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,), grad (8, n); all fp32,
// contiguous, on the device; n a multiple of 64. Returns cudaGetLastError().
int emap_mlp_value_and_grad(const float* pts, const float* W, const float* B,
                            float* udf, float* grad, float* scratch,
                            long long n, const int* layout, float scale,
                            void* stream) {
  Layout lay;
  if (parse_layout(layout, scale, &lay) || n <= 0 || n % P)
    return (int)cudaErrorInvalidValue;
  FwdScratch s;
  fwd_carve(lay, scratch, (size_t)n, &s);
  mlp_value_and_grad_kernel<<<(unsigned)(n / P), NT, 0,
                              (cudaStream_t)stream>>>(pts, W, B, udf, grad, s,
                                                      lay, (size_t)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
