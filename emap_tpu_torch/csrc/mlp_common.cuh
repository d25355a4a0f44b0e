// Shared pieces of the fused UDF-MLP kernels (mlp_query.cu, mlp_train.cu,
// mlp_value.cu): the network layout, the activations and the in-kernel PE
// encode. Their tensor-core tile products are in mlp_mma.cuh.
//
// Layout: every per-point array is FEATURE-MAJOR, (rows, ld) with the point
// axis contiguous, as in the JAX package's Pallas kernels. One block owns
// one tile of points and walks it through every layer.
//
// The weights are the packed buffers of kernels/mlp_query.py::pack_weights:
// W (rmax, ldw) with layer l's (out_l, in_l) block at column off_l, and
// B (rmax, L). They are read per layer from global memory (2.2 MB at ABC
// width, resident in the 50 MB L2) through shared-memory stages.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace emap {

constexpr int MAXL = 16;   // most linear layers a layout may have
constexpr int P = 64;      // points per tile (one block)
constexpr int NT = 256;    // threads per block (8 warps)
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

// softplus(100 z)/100 in the stable form the JAX package uses, with a
// product in place of the IEEE division (within ~1 ulp of it).
__device__ __forceinline__ float softplus100(float z) {
  const float t = z * 100.f;
  return (fmaxf(t, 0.f) + log1pf(expf(-fabsf(t)))) * 0.01f;
}

__device__ __forceinline__ float sign_of(float y) {
  return (float)((y > 0.f) - (y < 0.f));
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

}  // namespace emap
