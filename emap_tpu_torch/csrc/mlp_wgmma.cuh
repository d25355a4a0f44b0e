// Hopper's own machinery for the fused field kernels (mlp_train_wgmma.cu):
// warpgroup matrix products (wgmma) with operands in shared memory, TMA
// copies between device and shared memory, the mbarriers that report them,
// and the register split between a producer warpgroup and its consumers.
// sm_90a only (wgmma and setmaxnreg exist for that target alone).
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

}  // namespace emap
