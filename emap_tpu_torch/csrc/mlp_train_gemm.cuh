// What #2's two wgmma libraries share (mlp_train_wgmma.cu, the (bf16, bf16)
// pair; mlp_train_tf32.cu, the pairs with a 3xTF32 tier): q-hat_0's PE
// Jacobian, the weight-gradient GEMM over bf16 factors (wbar_kernel: the
// bf16 adjoint's contraction, W-bar_l = R_l Q-hat_l^T + Z-hat_l U_l^T over
// KS fixed point ranges on wgmma fed by TMA) and the fixed-order reduce of
// its range partials and of the per-point blocks' bias partials
// (reduce_kernel). No atomics: two launches on the same inputs agree bit
// for bit. sm_90a only.
#pragma once

#include "mlp_wgmma.cuh"

namespace emap {

constexpr int G_STAGES = 4;                   // GEMM factor ring
constexpr int G_STAGE_BYTES = 4 * BOX_BYTES;  // 128 x 64 of each factor
constexpr int KS = 4;                         // GEMM point ranges
constexpr int MAXG = MAXL * 4;                // GEMM tiles, at most
constexpr int G_SMEM = G_STAGES * G_STAGE_BYTES + 2 * G_STAGES * 8 + 1024;

// q-hat_0 = (dPE/dx)^T gbar at feature r of point n (blocked layout).
__device__ __forceinline__ float pe_jacT_row(const float* pts,
                                             const float* gbar, size_t ld,
                                             size_t n, int r,
                                             const Layout& lay) {
  const int mr = lay.multires;
  if (r < 3) return gbar[(size_t)r * ld + n] * lay.scale;
  if (r < 3 + 6 * mr) {
    const bool is_sin = r < 3 + 3 * mr;
    const int q = is_sin ? r - 3 : r - 3 - 3 * mr;
    const int k = q / 3, j = q % 3;
    const float f = (float)(1 << k);
    const float t = gbar[(size_t)j * ld + n] * lay.scale;
    const float uf = pts[(size_t)j * ld + n] * lay.scale * f;
    return is_sin ? (f * cosf(uf)) * t : ((-f) * sinf(uf)) * t;
  }
  return 0.f;
}

struct GTile {
  int l, o0, i0;  // a 128 x 128 block of W-bar_l
};
struct GTiles {
  int count;
  GTile t[MAXG];
};

// Every 128 x 128 block of every layer's W-bar, layer by layer.
inline GTiles gemm_tiles(const Layout& lay) {
  GTiles tiles;
  tiles.count = 0;
  for (int l = 0; l < lay.L; ++l)
    for (int o0 = 0; o0 < lay.out[l]; o0 += 128)
      for (int i0 = 0; i0 < lay.in[l]; i0 += 128)
        tiles.t[tiles.count++] = GTile{l, o0, i0};
  return tiles;
}

// Points of each of the KS ranges: n / KS rounded up to 64.
inline long long gemm_chunk(long long n) {
  return ((n + KS - 1) / KS + 63) / 64 * 64;
}

}  // namespace emap

// The kernels, in the including file's anonymous namespace (mlp_wgmma.cuh:
// pack_kernel).
namespace {

// Per (tile, point range): wpart[range][o][off_l + i] = sum over the range
// of R_l[o] Q-hat_l[i] + Z-hat_l[o] U_l[i]. The producer loads a 64-point
// chunk of 128 factor rows of each operand a stage; consumer c takes rows
// [64 c, 64 c + 64) of the tile.
__global__ void __launch_bounds__(emap::NTW, 1)
    wbar_kernel(const __grid_constant__ CUtensorMap mf, emap::WLayout wl,
                emap::GTiles tiles, long long n, long long chunk,
                float* wpart) {
  using namespace emap;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G_STAGES * G_STAGE_BYTES);
  uint64_t* empty = full + G_STAGES;
  const GTile tl = tiles.t[blockIdx.x];
  const long long nb = (long long)blockIdx.y * chunk;
  const long long ne = nb + chunk < n ? nb + chunk : n;
  const int nch = nb < ne ? (int)((ne - nb + 63) / 64) : 0;
  const int total = 2 * nch;  // (R, Q-hat) chunks, then (Z-hat, U)

  if (threadIdx.x == 0) {
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < WG) {
    regs_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0;
      unsigned phase = 0;
      for (int c = 0; c < total; ++c) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], G_STAGE_BYTES);
        unsigned char* dst = ring + stage * G_STAGE_BYTES;
        const bool second = c >= nch;
        const int x = (int)(nb + 64LL * (second ? c - nch : c));
        const int ra = (second ? wl.rowZ : wl.rowR)[tl.l] + tl.o0;
        const int rb = (second ? wl.rowU : wl.rowQ)[tl.l] + tl.i0;
        for (int j = 0; j < 2; ++j) {
          tma_load(dst + j * BOX_BYTES, &mf, x, ra + 64 * j, &full[stage]);
          tma_load(dst + (2 + j) * BOX_BYTES, &mf, x, rb + 64 * j,
                   &full[stage]);
        }
        if (++stage == G_STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  regs_inc<232>();

  const int cw = threadIdx.x / WG - 1;
  const int t = threadIdx.x % WG, w = t >> 5, q = t & 31;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0;
  unsigned phase = 0;
  for (int c = 0; c < total; ++c) {
    mbar_wait(&full[stage], phase);
    const uint32_t b = smem_u32(ring + stage * G_STAGE_BYTES);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64n128<0, 0>(part, desc_kmajor(b + cw * BOX_BYTES, s),
                          desc_kmajor(b + 2 * BOX_BYTES, s), s);
    wg_commit();
    wg_wait0();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    if (++stage == G_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  const Layout& lay = wl.lay;
  const int out = lay.out[tl.l], in = lay.in[tl.l];
  float* wp = wpart + (size_t)blockIdx.y * lay.rmax * lay.ldw;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = tl.o0 + 64 * cw + 16 * w + (q >> 2) + 8 * (e >> 1);
      const int i = tl.i0 + 8 * j + 2 * (q & 3) + (e & 1);
      if (o < out && i < in)
        wp[(size_t)o * lay.ldw + lay.off[tl.l] + i] = acc[4 * j + e];
    }
}

// wbar[e] = the KS range partials of e in order (0 outside every layer's
// block), over blocks [0, wblocks); then bbar[e] = the per-point blocks'
// partials of e, a warp an element: lane k sums partials k, k + 32, ...,
// and the lanes' sums meet in a fixed tree.
__global__ void reduce_kernel(const float* __restrict__ wpart,
                              const float* __restrict__ bpart, float* wbar,
                              float* bbar, emap::WLayout wl, int nblk,
                              int wblocks) {
  using namespace emap;
  const Layout& lay = wl.lay;
  if ((int)blockIdx.x < wblocks) {
    const size_t count = (size_t)lay.rmax * lay.ldw;
    for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
         e += (size_t)wblocks * blockDim.x) {
      const int o = (int)(e / lay.ldw), col = (int)(e % lay.ldw);
      int l = 0;
      while (l + 1 < lay.L && col >= lay.off[l + 1]) ++l;
      float v = 0.f;
      if (o < lay.out[l])
        for (int k = 0; k < KS; ++k) v += wpart[(size_t)k * count + e];
      wbar[e] = v;
    }
    return;
  }
  const int count = lay.rmax * lay.L;
  const int warps = (gridDim.x - wblocks) * (blockDim.x / 32);
  const int lane = threadIdx.x & 31;
  for (int e = (blockIdx.x - wblocks) * (blockDim.x / 32) + threadIdx.x / 32;
       e < count; e += warps) {
    float v = 0.f;
    for (int b = lane; b < nblk; b += 32) v += bpart[(size_t)b * count + e];
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    if (lane == 0) bbar[e] = v;
  }
}

}  // namespace
