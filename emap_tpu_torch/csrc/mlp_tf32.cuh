// The 3xTF32 machinery of the wgmma field kernels (mlp_query_tf32.cu,
// mlp_value_tf32.cu, mlp_train_tf32.cu): the pre-split weight pack and its
// layout, the fp32 activation tile, the A fragments split in registers,
// `wgmma .tf32` with A from registers, and the TMA load of a ring entry.
// sm_90a only.
//
// The pack (pack_tf32_kernel) holds each hidden layer's W (forward block:
// out rows x in columns) and, for the query's reverse products, W^T
// (transposed block), pre-split into TF32 hi = rna(w) (rows [0, FMAX)) and
// lo = rna(w - hi) (rows [FMAX, 2 FMAX)), as a (2 FMAX, ldp) fp32 array of
// 128-byte rows that TMA loads in its 128-byte swizzle as 64-row x
// 32-column boxes. `.tf32` wgmma has no transpose bit: both operands in
// shared memory are K-major. Within each 8-column group the columns are
// permuted (tf32_perm), so that an accumulator fragment, stored to the
// activation tile as the epilogue holds it, loads back as wgmma's A
// fragment with no shuffle.
#pragma once

#include "mlp_wgmma.cuh"

namespace emap {

constexpr int T_BOX_BYTES = 64 * 32 * 4;  // a 64-row x 32-column box
constexpr int T_TILE_BYTES = PW * FMAX * 4;  // 64 points x 256 fp32

__host__ __device__ inline int r32(int x) { return (x + 31) / 32 * 32; }

// The 3xTF32 pack's layout: per layer l < L-1 (the head is fp32 FMA from
// W), its forward block (out_l rows, kf_l = roundup(in_l, 32) columns) at
// column offf_l and its transposed block (in_l rows, kt_l = roundup(out_l,
// 32) columns) at column ldf + offt_l of a (2 FMAX, ldp) fp32 array, hi in
// rows [0, FMAX), lo in [FMAX, 2 FMAX); rows past a block's live ones and
// columns past its contraction are zero. A forward-only pack (the value
// kernel's) is the same array without its transposed blocks: ldt 0, ldp
// ldf (forward_only).
struct TLayout {
  Layout lay;
  int ldf, ldt, ldp;
  int offf[MAXL], offt[MAXL], kf[MAXL], kt[MAXL];
};

// parse_layout, then what the TF32 kernels take: no layer wider than FMAX,
// each layer's input the last one's output (with the encoded x appended at
// a skip). 0 on success.
inline int parse_tf32(const int* h, float scale, TLayout* tl) {
  Layout& lay = tl->lay;
  if (parse_layout(h, scale, &lay) || lay.rmax > FMAX || lay.skip[0])
    return 1;
  int cf = 0, ct = 0;
  for (int l = 0; l < lay.L; ++l) {
    if (lay.in[l] > FMAX || lay.out[l] > FMAX) return 1;
    if (l > 0 && lay.in[l] != lay.out[l - 1] + (lay.skip[l] ? lay.d0 : 0))
      return 1;
    tl->kf[l] = r32(lay.in[l]);
    tl->kt[l] = r32(lay.out[l]);
    tl->offf[l] = cf;
    tl->offt[l] = ct;
    if (l < lay.L - 1) {
      cf += tl->kf[l];
      ct += tl->kt[l];
    }
  }
  tl->ldf = cf;
  tl->ldt = ct;
  tl->ldp = cf + ct;
  return 0;
}

// The layout of the pack without its transposed blocks.
inline TLayout forward_only(TLayout tl) {
  tl.ldt = 0;
  tl.ldp = tl.ldf;
  return tl;
}

// The feature at position p of an 8-column group of the pack: the A
// fragment's k positions q and q + 4 (a0/a1 and a2/a3, lane q % 4) hold
// features 2q and 2q + 1, the pair an accumulator fragment holds (columns
// 8 j + 2 (lane % 4) + {0, 1}).
__host__ __device__ inline int tf32_perm(int p) {
  return p < 4 ? 2 * p : 2 * (p - 4) + 1;
}

// Byte offset of feature f of point p in the activation tile: 1 KB a
// point, 32-byte groups of 8 features XOR-swizzled by the point's low 3
// bits, so the 8 points x 32 bytes of a warp's fragment loads and
// epilogue stores spread evenly over the banks.
__device__ __forceinline__ uint32_t tile_at(int p, int f) {
  return (uint32_t)(p * 1024 + ((((f >> 3) ^ (p & 7)) << 5) | ((f & 7) << 2)));
}

__device__ __forceinline__ float* tile_ptr(unsigned char* tile, int p,
                                           int f) {
  return reinterpret_cast<float*>(tile + tile_at(p, f));
}

// The A fragments of the 4 k8 steps of contraction chunk c (features 32 c
// .. 32 c + 31) for a warpgroup's rows p and p + 8 (thread t: p = 16 (t /
// 32) + (t % 32) / 4, q = t % 4), loaded from the activation tile and split
// into TF32 hi and lo: the pairs an accumulator fragment of that thread
// holds, so a thread reads only what it wrote.
__device__ __forceinline__ void split_a_chunk(unsigned char* tile, int p,
                                              int q, int c,
                                              unsigned (&ah)[4][4],
                                              unsigned (&al)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int f = 32 * c + 8 * s + 2 * q;
    const float2 v0 = *reinterpret_cast<const float2*>(tile_ptr(tile, p, f));
    const float2 v1 =
        *reinterpret_cast<const float2*>(tile_ptr(tile, p + 8, f));
    split3(v0.x, ah[s][0], al[s][0]);
    split3(v1.x, ah[s][1], al[s][1]);
    split3(v0.y, ah[s][2], al[s][2]);
    split3(v1.y, ah[s][3], al[s][3]);
  }
}

// d (+)= A B over one k8 step, m64 nNW, tf32 operands: A from registers
// (a[i] of warp w, lane q: row 16 w + q / 4 + 8 (i & 1), k position q % 4
// + 4 (i >> 1)), B K-major from shared memory; fp32 accumulators in
// wgmma_m64n128's layout (mlp_wgmma.cuh), the first NW / 2 of d; d is
// zeroed first when !accumulate.
template <int NW>
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const unsigned (&a)[4],
                                           uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<40>(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The same at m64n64 into a 32-register accumulator of its own.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Keeps a register fragment's values where they are computed: the
// compiler may not move their computation past this point (a wgmma.fence
// must follow every write of a wgmma's register operand).
__device__ __forceinline__ void pin(unsigned (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]));
}

// One ring entry's TMA loads: `boxes` 64-row boxes of the pack's hi rows
// from `row` on, at columns col .. col + 31, to dst, and the same rows of
// lo `lo_off` bytes after them; bar counts the bytes.
__device__ __forceinline__ void tma_entry(unsigned char* dst,
                                          const CUtensorMap* mp, int col,
                                          int row, int boxes, int lo_off,
                                          uint64_t* bar) {
  for (int j = 0; j < boxes; ++j) {
    tma_load(dst + j * T_BOX_BYTES, mp, col, row + 64 * j, bar);
    tma_load(dst + lo_off + j * T_BOX_BYTES, mp, col, FMAX + row + 64 * j,
             bar);
  }
}

// A map of the (2 FMAX, cols) fp32 pack with 64-row x 32-column boxes (128
// bytes a row) in the 128-byte swizzle. 0 on success.
inline int f32_box_map(CUtensorMap* map, void* base, long long rows,
                       long long cols) {
  const EncodeTiled fn = encode_tiled();
  if (!fn || cols % 4 || rows <= 0 || cols <= 0) return 1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS;
}

}  // namespace emap

// The prologue, W (rmax, ldw) fp32 -> the 3xTF32 pack (2 FMAX, ldp): each
// element of a layer's forward or transposed block, at its permuted
// column, split into hi = rna(w) and lo = rna(w - hi). In the including
// file's anonymous namespace, as mlp_wgmma.cuh's pack_kernel.
namespace {

__global__ void pack_tf32_kernel(const float* __restrict__ W,
                                 float* __restrict__ pk, emap::TLayout tl) {
  using namespace emap;
  const Layout& lay = tl.lay;
  const size_t total = (size_t)2 * FMAX * tl.ldp;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (size_t)gridDim.x * blockDim.x) {
    const int r = (int)(e / tl.ldp) % FMAX, col = (int)(e % tl.ldp);
    const bool trans = col >= tl.ldf;
    const int c = trans ? col - tl.ldf : col;
    const int* off = trans ? tl.offt : tl.offf;
    int l = 0;
    while (l + 2 < lay.L && c >= off[l + 1]) ++l;
    const int k = ((c - off[l]) & ~7) | tf32_perm((c - off[l]) & 7);
    // forward: W_l[r, k]; transposed: W_l[k, r]
    const int o = trans ? k : r, i = trans ? r : k;
    const float v = o < lay.out[l] && i < lay.in[l]
                        ? W[(size_t)o * lay.ldw + lay.off[l] + i]
                        : 0.f;
    const unsigned hi = tf32_rna(v);
    pk[e] = e < total / 2 ? __uint_as_float(hi)
                          : __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
}

}  // namespace
