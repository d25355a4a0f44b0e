// Shared pieces of the fused UDF-MLP kernels (mlp_query.cu, mlp_train.cu,
// mlp_value.cu).
//
// Layout: every per-point array is FEATURE-MAJOR, (rows, ld) with the point
// axis contiguous, as in the JAX package's Pallas kernels. One block of NT
// threads owns one tile of P points and walks it through every layer.
// mlp_query.cu and mlp_train.cu keep the per-layer vectors of a tile in a
// device-memory scratch buffer that the Python wrapper allocates: rows x ld
// floats, ld = N, so a tile's rows sit at column offset n0 of every row. At
// the training step's N = 116,736 it takes 1.5 GB (forward) or 5.7 GB
// (backward), far beyond the 50 MB L2: only a block's layer-to-layer
// working set may stay in L2, and the stored activations and sigmoids that
// the reverse chains read back come from device memory. mlp_value.cu keeps
// its tile in shared memory instead (ld = P, n0 = 0).
//
// The weights are the packed buffers of kernels/mlp_query.py::pack_weights:
// W (rmax, ldw) with layer l's (out_l, in_l) block at column off_l, and
// B (rmax, L). They are read per layer from global memory (2.2 MB at ABC
// width, resident in the 50 MB L2) through shared-memory stages.
//
// All arithmetic is fp32 FMA on the CUDA cores; no tensor cores yet.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace emap {

constexpr int MAXL = 16;   // most linear layers a layout may have
constexpr int P = 64;      // points per tile (one block)
constexpr int NT = 256;    // threads per block (16 x 16, 4 x 4 outputs each)
constexpr int BM = 64;     // output rows per pass of tile_gemm
constexpr int BK = 16;     // contraction depth per shared-memory stage
constexpr int BMP = BM + 1;  // padded stage row: spreads stores over banks
constexpr float INV_SQRT2 = 0.70710678118654752440f;

// Network shape, parsed from the int array built by
// kernels/mlp_query.py::kernel_layout.
// rmax is the packed weights' row count (widest output); smax the widest
// layer input or output, which sizes the scratch rows.
struct Layout {
  int L, d0, d0p, multires, udf_type, ldw, rmax, smax;
  int in[MAXL], out[MAXL], off[MAXL], skip[MAXL];
  float scale;
};

// udf_type codes (kernel_layout): 0 abs, 1 square, 2 sdf.
inline int parse_layout(const int* h, float scale, Layout* lay) {
  lay->L = h[0];
  lay->d0 = h[1];
  lay->d0p = h[2];
  lay->multires = h[3];
  lay->udf_type = h[4];
  lay->ldw = h[5];
  lay->rmax = h[6];
  lay->scale = scale;
  if (lay->L < 2 || lay->L > MAXL || lay->multires < 1 ||
      lay->d0 != 3 * (2 * lay->multires + 1) || lay->d0p < lay->d0 ||
      lay->udf_type < 0 || lay->udf_type > 2)
    return 1;
  lay->smax = lay->rmax;
  for (int l = 0; l < lay->L; ++l) {
    lay->in[l] = h[7 + 4 * l];
    lay->out[l] = h[8 + 4 * l];
    lay->off[l] = h[9 + 4 * l];
    lay->skip[l] = h[10 + 4 * l];
    if (lay->out[l] > lay->rmax || lay->off[l] + lay->in[l] > lay->ldw)
      return 1;
    if (lay->in[l] > lay->smax) lay->smax = lay->in[l];
  }
  if (lay->in[0] != lay->d0p || lay->out[lay->L - 1] != 1) return 1;
  return 0;
}

// A feature-major operand of K rows: rows [0, ka) from `a`, rows [ka, K)
// from `b` (the skip concat [h; x]), each value times `scale`.
struct Rows {
  const float* a;
  int ka;
  const float* b;
  float scale;
};

__device__ __forceinline__ float rows_at(const Rows& r, int k, size_t ld,
                                         size_t n) {
  const float v = k < r.ka ? r.a[(size_t)k * ld + n]
                           : r.b[(size_t)(k - r.ka) * ld + n];
  return v * r.scale;
}

// softplus(100 z)/100 in the stable form the JAX package uses.
__device__ __forceinline__ float softplus100(float z) {
  const float t = z * 100.f;
  return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) / 100.f;
}

__device__ __forceinline__ float sigmoid100(float z) {
  return 1.f / (1.f + expf(-(z * 100.f)));
}

__device__ __forceinline__ float sign_of(float y) {
  return (float)((y > 0.f) - (y < 0.f));
}

// acc(m, p) = sum_{k < K} A(m, k) * X(k, n0 + p) for m < M and the tile's
// P points, then epi(m, p, acc) once per output. A(m, k) is W[m*ldw + k]
// (TRANS = false, W) or W[k*ldw + m] (TRANS = true, W^T). The epilogue must
// not write the rows X reads: X is reloaded for every pass of BM rows.
// Every thread of the block must call it (it synchronises the block).
template <bool TRANS, class Epi>
__device__ void tile_gemm(const float* __restrict__ W, int ldw, int M, int K,
                          const Rows& x, size_t ld, size_t n0, float* smem,
                          Epi epi) {
  float* As = smem;             // [BK][BMP]
  float* Xs = smem + BK * BMP;  // [BK][P]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int m0 = 0; m0 < M; m0 += BM) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int i = tid; i < BK * BM; i += NT) {
        int kk, mm;
        if (TRANS) {
          mm = i % BM;
          kk = i / BM;
        } else {
          kk = i % BK;
          mm = i / BK;
        }
        const int m = m0 + mm, k = k0 + kk;
        float v = 0.f;
        if (m < M && k < K)
          v = TRANS ? W[(size_t)k * ldw + m] : W[(size_t)m * ldw + k];
        As[kk * BMP + mm] = v;
      }
      for (int i = tid; i < BK * P; i += NT) {
        const int pp = i % P, kk = i / P, k = k0 + kk;
        Xs[kk * P + pp] = k < K ? rows_at(x, k, ld, n0 + pp) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk * BMP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Xs[kk * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty + 16 * i;
      if (m < M) {
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(m, tx + 16 * j, acc[i][j]);
      }
    }
  }
  __syncthreads();
}

// In-kernel positional encoding of the tile's raw points pts (8, ld), first
// 3 rows live, into X (d0p, ld) in the blocked layout
// [u, sin(u f_k) (k-major), cos(u f_k) (k-major), zero pad], u = pts*scale,
// f_k = 2^k (kernels/mlp_query.py::encode_fused).
__device__ __forceinline__ float encode_row(const float* pts, size_t ld,
                                            size_t n, int r,
                                            const Layout& lay) {
  const int m = lay.multires;
  if (r < 3) return pts[(size_t)r * ld + n] * lay.scale;
  if (r < 3 + 6 * m) {
    const bool is_sin = r < 3 + 3 * m;
    const int q = is_sin ? r - 3 : r - 3 - 3 * m;
    const int k = q / 3, j = q % 3;
    const float uf = pts[(size_t)j * ld + n] * lay.scale * (float)(1 << k);
    return is_sin ? sinf(uf) : cosf(uf);
  }
  return 0.f;
}

__device__ void encode_tile(const float* pts, size_t ld, size_t n0,
                            const Layout& lay, float* X) {
  for (int i = threadIdx.x; i < lay.d0p * P; i += NT) {
    const int r = i / P;
    const size_t n = n0 + i % P;
    X[(size_t)r * ld + n] = encode_row(pts, ld, n, r, lay);
  }
}

}  // namespace emap
