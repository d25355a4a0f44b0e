// Hopper's own machinery for the fused field kernels (mlp_train_wgmma.cu,
// mlp_query_wgmma.cu; the 3xTF32 kernels, through mlp_tf32.cuh, take the
// mbarrier, TMA, warpgroup and side-array pieces): warpgroup matrix
// products (wgmma) with operands in
// shared memory, TMA copies between device and shared memory, the
// mbarriers that report them, the register split between a producer
// warpgroup and its consumers, and the chain engine the two kernels share
// (the bf16 weight pack, the TMA producer of weight chunks, the promoted
// chain product, the accumulator indexing and the head's one-row
// products). sm_90a only (wgmma and setmaxnreg exist for that target
// alone).
//
// Shared-memory tiles are 64 x 64 bf16 boxes of 8 KB, 128-byte rows in
// TMA's 128-byte swizzle: the 16-byte chunk j of row r sits at chunk
// j ^ (r & 7), box bases 1024-byte aligned. A wgmma operand read from such
// rows is
//   K-major (the contraction index runs along a row): 8-row groups 1024
//     bytes apart (SBO), a k16 step 32 bytes along the row;
//   MN-major (the output index runs along a row, wgmma's transpose bit):
//     8-row groups along K 1024 bytes apart (SBO), 64-wide atoms along M or
//     N a box (LBO) apart, a k16 step two groups, 2048 bytes.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda call is linked
#include <stdint.h>

#include "mlp_mma.cuh"

namespace emap {

constexpr int BOX_BYTES = 64 * 64 * 2;      // one 64 x 64 bf16 box
constexpr int ROW_BYTES = 128;              // a box row, one swizzle span

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of element (r, c) of a tile of 128-byte bf16 rows in the
// 128-byte swizzle, from a 1024-byte aligned base.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * ROW_BYTES +
                    ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1)));
}

// x rounded to bf16 (to nearest, ties to even), as its 16 bits.
__device__ __forceinline__ unsigned short bf16_bits(float x) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
  return h;
}

__device__ __forceinline__ void st_bf16(unsigned char* tile, int r, int c,
                                        float x) {
  *reinterpret_cast<unsigned short*>(tile + swz(r, c)) = bf16_bits(x);
}

__device__ __forceinline__ float ld_bf16(const unsigned char* tile, int r,
                                         int c) {
  const unsigned short h =
      *reinterpret_cast<const unsigned short*>(tile + swz(r, c));
  return __uint_as_float((unsigned)h << 16);
}

// ---- mbarriers --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A wait that
// outlasts every real one (2^22 tries, each suspending up to a few
// microseconds) traps, so a schedule fault fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 22)) asm volatile("trap;\n");
  }
}

// ---- TMA ----------------------------------------------------------------

// One box of the 2-D map at (x inner, y outer) into shared memory; bar
// counts its bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// One box from shared memory to the 2-D map at (x, y); elements outside
// the map's dimensions are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(map),
      "r"(smem_u32(src)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The issuing thread's stores have finished reading shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ... and have been written.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of this thread become visible to the async proxy
// (wgmma operand reads, TMA stores) after a barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Starts bringing `bytes` (a multiple of 16) at global address p into L2.
__device__ __forceinline__ void l2_prefetch(const void* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(p),
               "r"(bytes)
               : "memory");
}

// ---- warpgroups ---------------------------------------------------------

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- wgmma --------------------------------------------------------------

// Descriptor of a 128-byte-swizzled operand at shared address `addr`
// (1024-byte aligned but for a k16 offset along a K-major row).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand rows (points or weight rows), k16 step s of the chunk
// at `addr`.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr, int s) {
  return wg_desc(addr + 32 * s, 16, 1024);
}

// MN-major operand: K rows of 128 bytes, 64-wide atoms BOX_BYTES apart.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr, int s) {
  return wg_desc(addr + 2048 * s, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (+)= A B over one k16 step, m64 n128, bf16 operands from shared memory,
// fp32 accumulators; d is zeroed first when !accumulate. TA, TB: the
// transpose bits (1: that operand is MN-major). The accumulator layout: of
// the warpgroup's thread t (warp w = t / 32, lane q = t % 32), d[4 j + e]
// holds row 16 w + q / 4 + 8 (e >> 1), column 8 j + 2 (q % 4) + (e & 1).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime has loaded, so the
// library links no -lcuda; null if that has none.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = (EncodeTiled)p;
  }
  return fn;
}

// A map of a row-major (rows, cols) bf16 array with 64 x 64 boxes in the
// 128-byte swizzle; boxes reaching past the array read zeros. 0 on
// success.
inline int bf16_box_map(CUtensorMap* map, void* base, long long rows,
                        long long cols) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || cols % 8 || rows <= 0 || cols <= 0) return 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS;
}

// ---- the chain engine ------------------------------------------------------
//
// A block is a producer warpgroup (one thread issues the TMA loads) and two
// consumer warpgroups of PW points each. A consumer walks its points
// through the chain products of a layer stack: each product's result is
// written once as bf16 into a 256-row activation tile (a 128-byte row of 64
// points a feature, read MN-major as wgmma's A), the next product's input.
// The weights stream as 64 x 128 chunks of the bf16 pack through a ring of
// STAGES mbarrier stages, in the consumers' order.

constexpr int WG = 128;                       // threads of a warpgroup
constexpr int NTW = 3 * WG;                   // producer + 2 consumers
constexpr int PW = 64;                        // points of a consumer
constexpr int PB = 2 * PW;                    // points of a block
constexpr int FMAX = 256;                     // widest layer; tile rows
constexpr int TILE_BYTES = FMAX * ROW_BYTES;  // one activation tile
constexpr int STAGES = 4;                     // weight ring stages
constexpr int STAGE_BYTES = 2 * BOX_BYTES;    // a 64 x 128 weight chunk
constexpr int SIDE = FMAX * PW;               // floats of a side array

// The layout of kernels/mlp_query.py::pack_weights and what the wgmma
// kernels add to it: the bf16 weight pack (FMAX rows, ldwb columns, layer
// l's block at column offb_l, in_l columns padded to kpad_l = roundup(in_l,
// 64)) and the factor rows mlp_train_wgmma.cu stores (frows x n bf16): per
// layer U_l and Q-hat_l (kpad_l rows each), R_l and Z-hat_l (opad_l =
// roundup(out_l, 64) rows).
struct WLayout {
  Layout lay;
  int ldwb, frows;
  int offb[MAXL], kpad[MAXL], opad[MAXL];
  int rowU[MAXL], rowQ[MAXL], rowR[MAXL], rowZ[MAXL];
};

inline int ru64(int x) { return (x + 63) / 64 * 64; }

// parse_layout, then what the wgmma kernels take: no layer wider than
// FMAX, and each layer's input the last one's output, with the encoded x
// appended at a skip. 0 on success.
inline int parse_wgmma(const int* h, float scale, WLayout* wl) {
  Layout& lay = wl->lay;
  if (parse_layout(h, scale, &lay) || lay.rmax > FMAX || lay.skip[0])
    return 1;
  int col = 0, row = 0;
  for (int l = 0; l < lay.L; ++l) {
    if (lay.in[l] > FMAX || lay.out[l] > FMAX) return 1;
    if (l > 0 && lay.in[l] != lay.out[l - 1] + (lay.skip[l] ? lay.d0 : 0))
      return 1;
    wl->kpad[l] = ru64(lay.in[l]);
    wl->opad[l] = ru64(lay.out[l]);
    wl->offb[l] = col;
    col += wl->kpad[l];
    wl->rowU[l] = row;
    row += wl->kpad[l];
    wl->rowQ[l] = row;
    row += wl->kpad[l];
    wl->rowR[l] = row;
    row += wl->opad[l];
    wl->rowZ[l] = row;
    row += wl->opad[l];
  }
  wl->ldwb = col;
  wl->frows = row;
  return 0;
}

// A chain product of layer l: N outputs a point over a K-deep contraction.
// Forward and ascend (trans false) take W_l as it is: N = out_l, K =
// kpad_l. Gradient and descend (trans true) take W_l^T: N = in_l, K =
// opad_l. N runs in halves of 128, K in chunks of 64.
__host__ __device__ inline void prod_shape(const WLayout& wl, int l,
                                           bool trans, int& N, int& K) {
  N = trans ? wl.lay.in[l] : wl.lay.out[l];
  K = trans ? wl.opad[l] : wl.kpad[l];
}

// The producer: every weight chunk of the consumers' chain products, in
// their order, two 64 x 64 boxes a stage. PAIRS times: the forward
// products of layers 0 .. L-2, then the transposed ones of L-2 down to LOW.
template <int PAIRS, int LOW>
__device__ void produce_chunks(const CUtensorMap* mw, const WLayout& wl,
                               unsigned char* ring, uint64_t* full,
                               uint64_t* empty) {
  int stage = 0;
  unsigned phase = 0;
  auto product = [&](int l, bool trans) {
    int N, K;
    prod_shape(wl, l, trans, N, K);
    for (int h = 0; h * 128 < N; ++h)
      for (int c = 0; c < K / 64; ++c) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_expect_tx(&full[stage], STAGE_BYTES);
        unsigned char* dst = ring + stage * STAGE_BYTES;
        for (int j = 0; j < 2; ++j) {
          // forward: rows (outputs) 128 h + 64 j, columns 64 c of the
          // block; transposed: rows 64 c, columns 128 h + 64 j
          const int x = wl.offb[l] + (trans ? 128 * h + 64 * j : 64 * c);
          const int y = trans ? 64 * c : 128 * h + 64 * j;
          tma_load(dst + j * BOX_BYTES, mw, x, y, &full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
  };
  const int L = wl.lay.L;
  for (int k = 0; k < PAIRS; ++k) {
    for (int l = 0; l < L - 1; ++l) product(l, false);
    for (int l = L - 2; l >= LOW; --l) product(l, true);
  }
}

// acc = one 128-wide half of a chain product for the warpgroup's 64
// points: A the activation tile at a_addr (MN-major), B the ring's chunks
// (K-major, or MN-major when TB). Each chunk's 64 steps go into `part`,
// then into acc with a rounded fp32 add.
template <int TB>
__device__ __forceinline__ void product_half(float (&acc)[64],
                                             float (&part)[64],
                                             uint32_t a_addr, uint32_t ring,
                                             int K, int& stage,
                                             unsigned& phase, uint64_t* full,
                                             uint64_t* empty) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0; c < K / 64; ++c) {
    mbar_wait(&full[stage], phase);
    const uint32_t b = ring + stage * STAGE_BYTES;
    const uint32_t a = a_addr + c * 64 * ROW_BYTES;
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_m64n128<1, TB>(part, desc_mnmajor(a, s),
                           TB ? desc_mnmajor(b, s) : desc_kmajor(b, s), s);
    wg_commit();
    wg_wait0();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// Of a consumer's thread t (warp t / 32, lane q = t % 32), the
// accumulator element 4 j + e of a 128-wide half h holds this point (row of
// the m64 tile) and this feature (column of the n128 half): wgmma_m64n128's
// layout.
__device__ __forceinline__ int acc_point(int t, int e) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int acc_feature(int t, int h, int j, int e) {
  return 128 * h + 8 * j + 2 * (t & 3) + (e & 1);
}

// The float4 of a side array (SIDE fp32 values of one tile and layer) that
// consumer thread t owns for the accumulator elements 4 j .. 4 j + 3 of
// half h: written and read back by that thread alone, coalesced.
__device__ __forceinline__ float4* side_slot(float* arr, int h, int j,
                                             int t) {
  return reinterpret_cast<float4*>(arr) + (h * 16 + j) * WG + t;
}

// The same slot's four values stored as fp32 (float arrays) or rounded to
// bf16, to nearest even (unsigned short arrays: the JAX extraction query's
// sigmoid residuals, f32_residuals=False), and read back as fp32.
__device__ __forceinline__ void side_put(float* arr, int h, int j, int t,
                                         float4 v) {
  *side_slot(arr, h, j, t) = v;
}
__device__ __forceinline__ void side_put(unsigned short* arr, int h, int j,
                                         int t, float4 v) {
  reinterpret_cast<uint2*>(arr)[(h * 16 + j) * WG + t] = make_uint2(
      bf16_bits(v.x) | ((unsigned)bf16_bits(v.y) << 16),
      bf16_bits(v.z) | ((unsigned)bf16_bits(v.w) << 16));
}
__device__ __forceinline__ float4 side_get(float* arr, int h, int j, int t) {
  return *side_slot(arr, h, j, t);
}
__device__ __forceinline__ float4 side_get(unsigned short* arr, int h, int j,
                                           int t) {
  const uint2 u = reinterpret_cast<uint2*>(arr)[(h * 16 + j) * WG + t];
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// The head's dot w . tile over `in` features at tier bf16 for a
// warpgroup's 64 points, a point per pair of threads, the two partial sums
// (through red, 2 x PW floats of this warpgroup) added in a fixed order:
// out[p] = sum + bias. Two barriers `bar` of the warpgroup.
__device__ __forceinline__ void wg_head_dot(const float* whead, int in,
                                            const unsigned char* tile,
                                            float* red, float* out,
                                            float bias, int t, int bar) {
  const int p = t % PW, half = t / PW;
  float s = 0.f;
  for (int f = half; f < in; f += 2)
    s = fmaf(tier_operand<BF16>(whead[f]), ld_bf16(tile, f, p), s);
  red[half * PW + p] = s;
  named_sync(bar, WG);
  if (t < PW) out[p] = (red[p] + red[PW + p]) + bias;
  named_sync(bar, WG);
}

// The head's transposed product, half h: acc = w[f] v[p] at tier bf16 for
// the features f < in, 0 past them.
__device__ __forceinline__ void wg_head_outer(float (&acc)[64],
                                              const float* whead, int in,
                                              const float* v, int h, int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int f = acc_feature(t, h, j, e);
      acc[4 * j + e] = f < in ? tier_operand<BF16>(whead[f]) *
                                    tier_operand<BF16>(v[acc_point(t, e)])
                              : 0.f;
    }
}

}  // namespace emap

// The prologue, W (rmax, ldw) fp32 -> the bf16 pack (FMAX, ldwb), in the
// including file's anonymous namespace: a kernel in an anonymous namespace
// of emap beside the file's own would make nvcc's host stubs ambiguous.
namespace {

__global__ void pack_kernel(const float* __restrict__ W,
                            unsigned short* __restrict__ wb,
                            emap::WLayout wl) {
  using namespace emap;
  const Layout& lay = wl.lay;
  const size_t total = (size_t)FMAX * wl.ldwb;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / wl.ldwb), c = (int)(e % wl.ldwb);
    int l = 0;
    while (l + 1 < lay.L && c >= wl.offb[l + 1]) ++l;
    const int k = c - wl.offb[l];
    const float v = r < lay.rmax && k < lay.in[l]
                        ? W[(size_t)r * lay.ldw + lay.off[l] + k]
                        : 0.f;
    wb[e] = bf16_bits(v);
  }
}

}  // namespace
