// Fused UDF field query, value only: the dense extraction grid.
//
// Replaces: emap_tpu/kernels/mlp_query.py::_pallas_value (reached through
// pallas_udf_value from the grid pass of emap_tpu/extract/pointcloud.py and
// the probe certification of emap_tpu/extract/autothresh.py).
//
// Computes, per point: the in-kernel PE encode, 9 linears with
// softplus(100 z)/100 (skip concat scaled by 1/sqrt(2)), then the
// abs/square/sdf head divided by scale. No reverse pass, no residuals.
// Out: udf (ld,).
//
// Bound on the H100: operations. 2 * sum(in_l * out_l) FLOP a point
// (0.92 MFLOP at ABC width) against 36 bytes of input and output a point;
// a 128^3 grid pass (2,097,152 points) is 1.93 TFLOP, >= 28.7 ms at the fp32
// FMA peak (67 TFLOP/s).
// Design: a forward pass keeps only two activation vectors a point, so the
// whole tile lives in shared memory: one block of 256 threads walks 64
// points through every layer with the encoded input (d0p x 64) and two
// activation buffers (smax x 64, ping-pong) in dynamic shared memory,
// 152 KB at ABC width (one block per SM). No device scratch: the launch
// allocates nothing beyond its input and output. Weights stream from L2
// through tile_gemm's 16-deep shared-memory stages; each thread accumulates
// a 4 x 4 register tile in fp32 FMA.

#include "mlp_common.cuh"

using namespace emap;

namespace {

// Floats of dynamic shared memory a block takes: tile_gemm's stages, the
// encoded tile and two activation buffers.
size_t value_smem_floats(const Layout& lay) {
  return (size_t)BK * BMP + (size_t)BK * P + (size_t)lay.d0p * P +
         2 * (size_t)lay.smax * P;
}

__global__ void __launch_bounds__(NT)
    mlp_value_kernel(const float* pts, const float* __restrict__ W,
                     const float* __restrict__ B, float* udf, Layout lay,
                     size_t ld) {
  extern __shared__ float smem[];
  float* stage = smem;                          // [BK][BMP] + [BK][P]
  float* X = stage + BK * BMP + BK * P;         // (d0p, P) encoded input
  float* A0 = X + (size_t)lay.d0p * P;          // (smax, P) activations,
  float* A1 = A0 + (size_t)lay.smax * P;        // ping-pong
  const size_t n0 = (size_t)blockIdx.x * P;
  const int L = lay.L;

  for (int i = threadIdx.x; i < lay.d0p * P; i += NT)
    X[i] = encode_row(pts, ld, n0 + i % P, i / P, lay);
  __syncthreads();

  // The tile's rows are read from shared memory with leading dimension P
  // and point offset 0; tile_gemm reloads them for every pass of BM rows,
  // so each layer writes the buffer it does not read.
  const float* h = X;
  for (int l = 0; l < L; ++l) {
    Rows src{h, lay.in[l], h, 1.f};
    if (l > 0 && lay.skip[l]) src = Rows{h, lay.out[l - 1], X, INV_SQRT2};
    const float* Wl = W + lay.off[l];
    if (l < L - 1) {
      float* a_out = (l & 1) ? A1 : A0;
      tile_gemm<false>(Wl, lay.ldw, lay.out[l], lay.in[l], src, P, 0, stage,
                       [&](int m, int p, float acc) {
                         a_out[m * P + p] = softplus100(acc + B[m * L + l]);
                       });
      h = a_out;
    } else {
      tile_gemm<false>(Wl, lay.ldw, 1, lay.in[l], src, P, 0, stage,
                       [&](int, int p, float acc) {
                         const float y0 = acc + B[l];
                         const float u = lay.udf_type == 0   ? fabsf(y0)
                                         : lay.udf_type == 1 ? y0 * y0
                                                             : y0;
                         udf[n0 + p] = u / lay.scale;
                       });
    }
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block takes; -1 on a bad layout.
long long emap_mlp_value_smem_bytes(const int* layout) {
  Layout lay;
  if (parse_layout(layout, 1.f, &lay)) return -1;
  return (long long)(value_smem_floats(lay) * sizeof(float));
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,); all fp32, contiguous,
// on the device; n a multiple of 64. Returns the CUDA error of the shared
// memory opt-in, else cudaGetLastError() after the launch.
int emap_mlp_value(const float* pts, const float* W, const float* B,
                   float* udf, long long n, const int* layout, float scale,
                   void* stream) {
  Layout lay;
  if (parse_layout(layout, scale, &lay) || n <= 0 || n % P)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = value_smem_floats(lay) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_value_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  mlp_value_kernel<<<(unsigned)(n / P), NT, bytes, (cudaStream_t)stream>>>(
      pts, W, B, udf, lay, (size_t)n);
  return (int)cudaGetLastError();
}

}  // extern "C"
