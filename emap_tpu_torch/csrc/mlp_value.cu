// Fused UDF field query, value only: the dense extraction grid, on the
// tensor cores.
//
// Replaces: emap_tpu/kernels/mlp_query.py::_pallas_value (reached through
// pallas_udf_value from the grid pass of emap_tpu/extract/pointcloud.py and
// the probe certification of emap_tpu/extract/autothresh.py) at the bf16
// tier. At 3xTF32 mlp_value_tf32.cu (wgmma) runs the path, and this
// kernel is timed beside it (kernels/mlp_query.py::value_mma_sync).
//
// Computes, per point: the in-kernel PE encode, 9 linears with
// softplus(100 z)/100 (skip concat scaled by 1/sqrt(2)), then the
// abs/square/sdf head divided by scale. No reverse pass, no residuals, no
// device scratch. Out: udf (ld,). Every product at one tier (mlp_mma.cuh:
// Tier), as the Pallas kernel runs them at cfg.precision.
//
// Bound on the H100: operations. 2 * sum(in_l * out_l) FLOP a point
// (0.92 MFLOP at ABC width) against 36 bytes of input and output a point;
// a 128^3 grid pass (2,097,152 points) is 1.93 TFLOP: >= 28.7 ms at the
// fp32 FMA peak (67 TFLOP/s), >= 3.9 ms for one TF32 pass at the
// tensor-core peak (495 TFLOP/s) and >= 11.7 ms for the three of the split;
// >= 1.95 ms for the BF16 tier's one pass at 989 TFLOP/s.
// Design: the forward half of mlp_query.cu's kernel. The 8 hidden products
// run as mma.sync tile products at the tier (mlp_mma.cuh: tc_product; 3xTF32
// at fp32 accuracy or one bf16 pass, sums promoted every 32 contraction
// steps); the one-row head is fp32 FMA (of bf16-rounded operands at BF16).
// One block of 8 warps walks a 64-point tile through every layer with its
// activations and encoded input in shared memory (167 KB at ABC width with
// the weight ring: one block per SM); the tile never leaves the SM. scripts/torch_kernel_ablation.py measures the alternatives (a
// 128-point tile, weights split once a launch, one weight stream over all
// layers).

#include "mlp_mma.cuh"

using namespace emap;

namespace {

// Shared-memory floats of a block: the ring, the tile (act), the encoded
// input (X) and the head's partial sums.
__host__ __device__ inline size_t value_smem_floats(const Layout& lay) {
  const TileSmem ts = tile_smem(lay);
  return (size_t)RING + (size_t)(ts.ar + ts.xr) * SA + 4 * P;
}

template <Tier T>
__global__ void __launch_bounds__(NT, 1)
    mlp_value_kernel(const float* pts, const float* __restrict__ W,
                     const float* __restrict__ B, float* udf, Layout lay,
                     size_t ld) {
  extern __shared__ float4 smem4[];
  const TileSmem ts = tile_smem(lay);
  float* ring = reinterpret_cast<float*>(smem4);
  float* act = ring + RING;               // (ar, SA) activations
  float* X = act + (size_t)ts.ar * SA;     // (xr, SA) encoded input
  float* red = X + (size_t)ts.xr * SA;     // (4, P) head partial sums
  const size_t n0 = (size_t)blockIdx.x * P;
  const int L = lay.L;
  const Frag f = frag_points();

  for (int i = threadIdx.x; i < ts.ar * SA; i += NT) act[i] = 0.f;
  for (int i = threadIdx.x; i < ts.xr * SA; i += NT) {
    const int r = i / SA, p = i % SA;
    X[i] = r < lay.d0p && p < P ? encode_row(pts, ld, n0 + p, r, lay) : 0.f;
  }
  __syncthreads();

  // z_l = W_l u_l + b_l; the tile keeps u_{l+1} = softplus100(z_l), scaled
  // by 1/sqrt2 with the encoded x appended below it ahead of the skip layer
  Acc acc;
  const float* h = X;
  for (int l = 0; l < L - 1; ++l) {
    const int M = lay.out[l];
    tc_product<T, false>(W + lay.off[l], lay.ldw, M, lay.in[l], h, ring,
                         acc);
    const float s = lay.skip[l + 1] ? INV_SQRT2 : 1.f;
    for_groups(M, [&](int mt, int nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = frag_m(f, mt, e);
        if (m < M)
          act[m * SA + frag_p(f, nt, e)] =
              softplus100(acc[mt][nt][e] + B[m * L + l]) * s;
      }
    });
    if (lay.skip[l + 1])
      for (int i = threadIdx.x; i < lay.d0 * P; i += NT)
        act[(M + i / P) * SA + i % P] = X[(i / P) * SA + i % P] * s;
    __syncthreads();
    h = act;
  }
  head_dot<T>(W + lay.off[L - 1], lay.in[L - 1], act, red, red);
  if (threadIdx.x < P) {
    const float y0 = red[threadIdx.x] + B[L - 1];
    const float u = lay.udf_type == 0   ? fabsf(y0)
                    : lay.udf_type == 1 ? y0 * y0
                                        : y0;
    udf[n0 + threadIdx.x] = u / lay.scale;
  }
}

template <Tier T>
int launch(const float* pts, const float* W, const float* B, float* udf,
           const Layout& lay, long long n, cudaStream_t stream) {
  const size_t bytes = value_smem_floats(lay) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      mlp_value_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  mlp_value_kernel<T><<<(unsigned)(n / P), NT, bytes, stream>>>(
      pts, W, B, udf, lay, (size_t)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory a block takes; -1 on a layout the kernel
// does not take.
long long emap_mlp_value_smem_bytes(const int* layout) {
  Layout lay;
  if (parse_tc(layout, 1.f, &lay)) return -1;
  return (long long)(value_smem_floats(lay) * sizeof(float));
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,); all fp32, contiguous,
// on the device; n a multiple of 64; tier a Tier code. Returns
// cudaErrorInvalidValue on anything else, the CUDA error of the shared
// memory opt-in, else cudaGetLastError() after the launch.
int emap_mlp_value(const float* pts, const float* W, const float* B,
                   float* udf, long long n, const int* layout, float scale,
                   int tier, void* stream) {
  Layout lay;
  if (parse_tc(layout, scale, &lay) || n <= 0 || n % P)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tier == TF32X3) return launch<TF32X3>(pts, W, B, udf, lay, n, st);
  if (tier == BF16) return launch<BF16>(pts, W, B, udf, lay, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
