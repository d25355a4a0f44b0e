// Tensor-core tile products of the fused field queries (mlp_query.cu,
// mlp_train.cu, mlp_value.cu), at two tiers (Tier): mma.sync m16n8k8 TF32
// with a 3xTF32 split, fp32-accurate, or one mma.sync m16n8k16 bf16 pass.
//
// The tiers are the JAX package's matmul tiers as its kernels' _kernel_dot
// (emap_tpu/kernels/mlp_query.py:249-278) takes them, by conf name
// (kernels/mlp_query.py: kernel_tier): "default" is BF16, one pass with
// both operands rounded to bf16 by cvt.rn.bf16x2.f32 (to nearest, ties to
// even, as XLA's astype) and fp32 accumulators; "high" and "highest" are
// TF32X3, fp32 accuracy (the JAX package's "high", a 3-pass bf16 emulation
// of fp32, is a TPU workaround). The BF16 tier does 1/6 of the TF32X3
// tier's mma instructions, each twice as deep, with no operand split: 989
// TFLOP/s dense bf16 on the H100 SXM against 495 / 3 for fp32-accurate
// TF32.
//
// TF32X3 numbers: each operand x is split into hi = rna(x) and lo = rna(x - hi),
// rna the rounding of cvt.rna.tf32.f32 (10 mantissa bits, ties away from
// zero), and a product is lo*hi + hi*lo + hi*hi on the tensor cores with
// fp32 accumulation; the lo*lo term lies below fp32 roundoff. A product of
// two TF32 values is exact in fp32, so the result differs from an fp32 FMA
// dot product by the order of the sums and a ~2^-22 relative split
// residue: fp32 accuracy at three tensor-core passes (495 TFLOP/s dense
// TF32 on the H100 SXM, ~165 TFLOP/s fp32-accurate, against 67 TFLOP/s of
// fp32 FMA). The tensor cores add into their fp32 accumulator truncating,
// not rounding, so a long chain of mma drifts toward zero: every 32
// contraction steps (4 k8 steps of TF32X3, 2 k16 steps of BF16) are summed
// in a fresh accumulator and added to the running sum with a rounded fp32
// add, at both tiers. Over the 14,592 terms of a
// weight-gradient point range one chain leaves the worst block ~1e-4 off
// its plain version on the H100, the promoted sums under 1e-5
// (scripts/torch_kernel_ablation.py, no_promotion).
//
// Tile: a block of NT = 256 threads (8 warps) owns P = 64 points. The
// tile's per-point vectors live in shared memory, feature-major, (rows, SA)
// with SA = P + 8: the pad puts the 32 lanes of a fragment read on 32
// banks. A tile product acc(m, p) = sum_k A(m, k) X(k, p), m < M <= 256,
// gives warp w the rows [64 (w >> 1), +64) and the points [32 (w & 1), +32)
// of the 256 x 64 output, held in registers as Acc in mma.sync's
// C-fragment layout (frag_m, frag_p). A is a layer's weight block W or its
// transpose. W streams from L2 in chunks of KC = 32 contraction steps
// through a ring of NSLOT cp.async slots in shared memory, fp32, NSLOT - 1
// chunks ahead of the warps, with one block barrier a chunk; each warp
// splits (TF32X3) or rounds (BF16) its fragments as it reads them.
#pragma once

#include "mlp_common.cuh"

namespace emap {

// The tier of a tile product; the C interfaces take its code.
enum Tier : int { TF32X3 = 0, BF16 = 1 };

constexpr int SA = P + 8;          // tile row stride, floats
constexpr int KC = 32;             // contraction steps per W chunk
constexpr int SW = KC + 4;         // row stride of a W chunk (rows m)
constexpr int WMAX = 256;          // widest layer the kernels take
constexpr int ST = WMAX + 8;       // row stride of a W^T chunk (rows k)
constexpr int SLOT = WMAX * SW;    // floats per ring slot (>= KC * ST)
constexpr int NSLOT = 2;           // ring slots
constexpr int RING = NSLOT * SLOT;

typedef float Acc[4][4][4];  // [m16 tile][n8 tile][C-fragment element]

// A warp's place: 4 x 2 warps over (256 rows, 64 points) for the per-point
// products (points), 2 x 4 over a 128 x 128 block for the weight-gradient
// contraction (wbar).
struct Frag {
  int wm, wn, gid, tig;
};

__device__ __forceinline__ Frag frag_points() {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {w >> 1, w & 1, lane >> 2, lane & 3};
}

__device__ __forceinline__ Frag frag_wbar() {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return {w >> 2, w & 3, lane >> 2, lane & 3};
}

// Row and column of C-fragment element e of tile (mt, nt).
__device__ __forceinline__ int frag_m(const Frag& f, int mt, int e) {
  return f.wm * 64 + mt * 16 + f.gid + (e >> 1) * 8;
}
__device__ __forceinline__ int frag_p(const Frag& f, int nt, int e) {
  return f.wn * 32 + nt * 8 + 2 * f.tig + (e & 1);
}

// The layouts these kernels take beyond parse_layout: no layer wider than
// WMAX, 16-byte aligned W rows and blocks for cp.async (every in_l, offset
// and ldw a multiple of 4; in_l is d0p or d_hidden), and each layer's input
// the last one's output, with the encoded x appended at a skip.
// kernels/mlp_query.py::check_kernel_cfg refuses the same nets on every
// device before a launch.
inline bool tc_layout_ok(const Layout& lay) {
  if (lay.smax > WMAX || lay.ldw % 4) return false;
  for (int l = 0; l < lay.L; ++l) {
    if (lay.in[l] % 4 || lay.off[l] % 4) return false;
    if (l > 0 && lay.in[l] != lay.out[l - 1] + (lay.skip[l] ? lay.d0 : 0))
      return false;
  }
  return true;
}

// parse_layout, then tc_layout_ok: 0 on a layout the kernels take.
inline int parse_tc(const int* layout, float scale, Layout* lay) {
  return parse_layout(layout, scale, lay) || !tc_layout_ok(*lay);
}

// cvt.rna.tf32.f32's rounding of a finite x (and of +-inf) in two integer
// instructions; ptxas expands the cvt itself to four.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split3(float x, unsigned& hi, unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// lo and hi rounded to bf16 (to nearest, ties to even), packed with lo in
// the low half: the element of the smaller index in an mma.sync fragment.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x as a tier's products take it: rounded to bf16 (cvt.rn.bf16.f32) at
// BF16, unchanged at TF32X3. Used by the one-row head layer's fp32 FMA,
// where a product of two bf16 values is exact.
template <Tier T>
__device__ __forceinline__ float tier_operand(float x) {
  if constexpr (T == BF16) {
    unsigned short h;
    asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(x));
    return __uint_as_float((unsigned)h << 16);
  } else {
    return x;
  }
}

// 16 bytes global -> shared, zero-filled when !valid (src is then unread).
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void zero_acc(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

__device__ __forceinline__ void add_acc(Acc& acc, const Acc& part) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
}

// acc += A X over one KD-deep chunk at tier T. a_at(m, kk) and b_at(kk, n)
// give the chunk's fp32 operands (kk < KD), which the warp splits (TF32X3,
// 8 steps a pass) or rounds (BF16, 16 steps a pass) as it reads them; rows
// m >= M are skipped by 16-row tiles.
template <Tier T, int KD, class AAt, class BAt>
__device__ __forceinline__ void mma_chunk(Acc& acc, const Frag& f, int M,
                                          AAt a_at, BAt b_at) {
  if (f.wm * 64 >= M) return;  // warp-uniform
  if constexpr (T == TF32X3) {
#pragma unroll
    for (int ks = 0; ks < KD; ks += 8) {
      unsigned bh[4][2], bl[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = f.wn * 32 + nt * 8 + f.gid;
        split3(b_at(ks + f.tig, n), bh[nt][0], bl[nt][0]);
        split3(b_at(ks + f.tig + 4, n), bh[nt][1], bl[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (f.wm * 64 + mt * 16 >= M) continue;  // warp-uniform
        const int m = f.wm * 64 + mt * 16 + f.gid;
        unsigned ah[4], al[4];
        split3(a_at(m, ks + f.tig), ah[0], al[0]);
        split3(a_at(m + 8, ks + f.tig), ah[1], al[1]);
        split3(a_at(m, ks + f.tig + 4), ah[2], al[2]);
        split3(a_at(m + 8, ks + f.tig + 4), ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_tf32(acc[mt][nt], al, bh[nt]);
          mma_tf32(acc[mt][nt], ah, bl[nt]);
          mma_tf32(acc[mt][nt], ah, bh[nt]);
        }
      }
    }
  } else {
    static_assert(KD % 16 == 0, "a BF16 chunk is whole k16 steps");
    // m16n8k16 fragments: A's four registers hold (row, k) pairs (m, k),
    // (m + 8, k), (m, k + 8), (m + 8, k + 8) with k = ks + 2 tig and its
    // neighbour k + 1; B's two hold (k, n) and (k + 8, n), also with k + 1
#pragma unroll
    for (int ks = 0; ks < KD; ks += 16) {
      const int k = ks + 2 * f.tig;
      unsigned b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = f.wn * 32 + nt * 8 + f.gid;
        b[nt][0] = bf16x2(b_at(k, n), b_at(k + 1, n));
        b[nt][1] = bf16x2(b_at(k + 8, n), b_at(k + 9, n));
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (f.wm * 64 + mt * 16 >= M) continue;  // warp-uniform
        const int m = f.wm * 64 + mt * 16 + f.gid;
        const unsigned a[4] = {bf16x2(a_at(m, k), a_at(m, k + 1)),
                               bf16x2(a_at(m + 8, k), a_at(m + 8, k + 1)),
                               bf16x2(a_at(m, k + 8), a_at(m, k + 9)),
                               bf16x2(a_at(m + 8, k + 8), a_at(m + 8, k + 9))};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt]);
      }
    }
  }
}

// acc(m, p) = sum_{k < K} A(m, k) xs(k, p) at tier T for m < M <= WMAX and
// the tile's P points, with A(m, k) = W[m * ldw + k] (TRANS false: a layer's
// block, K = in_l, M = out_l) or W[k * ldw + m] (TRANS true: its
// transpose, K = out_l, M = in_l). xs is the tile in shared memory,
// stride SA, with at least roundup(K, KC) finite rows. ring holds RING
// floats. Chunk entries outside m < M, k < K are zero, so the rows of xs
// at and above K add nothing. Every thread of the block calls it; it
// synchronises the block, and on return every warp has finished reading xs
// and ring.
template <Tier T, bool TRANS>
__device__ __forceinline__ void tc_product(const float* __restrict__ W,
                                           int ldw, int M, int K,
                                           const float* xs, float* ring,
                                           Acc& acc) {
  const Frag f = frag_points();
  zero_acc(acc);
  const int nch = (K + KC - 1) / KC;
  const int Mr = (M + 15) & ~15;
  auto at = [](int m, int kk) { return TRANS ? kk * ST + m : m * SW + kk; };
  // chunk c into its slot, or an empty group past the last chunk, so that
  // every chunk is the same number of groups behind the newest
  auto load = [&](int c) {
    if (c < nch) {
      float* dst = ring + (c % NSLOT) * SLOT;
      const int k0 = c * KC;
      const int segs = TRANS ? KC * (Mr / 4) : Mr * (KC / 4);
      for (int s = threadIdx.x; s < segs; s += NT) {
        int m, kk;
        if constexpr (TRANS) {
          kk = s / (Mr / 4);
          m = (s % (Mr / 4)) * 4;
        } else {
          m = s / (KC / 4);
          kk = (s % (KC / 4)) * 4;
        }
        const bool ok = m < M && k0 + kk < K;
        const float* src = TRANS ? W + (size_t)(k0 + kk) * ldw + m
                                 : W + (size_t)m * ldw + k0 + kk;
        cp16(dst + at(m, kk), ok ? src : W, ok);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int c = 0; c < NSLOT - 1; ++c) load(c);
  for (int c = 0; c < nch; ++c) {
    cp_wait<NSLOT - 2>();
    // chunk c has landed for every thread, and every warp is past chunk
    // c - 1, whose slot the next load takes
    __syncthreads();
    load(c + NSLOT - 1);
    const float* cur = ring + (c % NSLOT) * SLOT;
    const float* xk = xs + (size_t)c * KC * SA;
    Acc part;
    zero_acc(part);
    mma_chunk<T, KC>(
        part, f, M, [&](int m, int kk) { return cur[at(m, kk)]; },
        [&](int kk, int p) { return xk[kk * SA + p]; });
    add_acc(acc, part);
  }
  __syncthreads();
}

// sigmoid(100 z) and softplus(100 z)/100 (mlp_common.cuh's stable form)
// from one exp(-|100 z|), with a correctly rounded reciprocal and a
// product in place of IEEE divisions (each within ~1 ulp of the divided
// form).
__device__ __forceinline__ void sig_softplus100(float z, float& sig,
                                                float& sp) {
  const float t = z * 100.f, e = expf(-fabsf(t));
  sig = (t >= 0.f ? 1.f : e) * __frcp_rn(1.f + e);
  sp = (fmaxf(t, 0.f) + log1pf(e)) * 0.01f;
}

// fn(mt, nt) for each of the thread's fragment groups (mt, nt) that holds a
// row below M (per-point layout): the group's values acc[mt][nt][e] sit at
// rows frag_m(f, mt, e) and points frag_p(f, nt, e), e < 4.
template <class F>
__device__ __forceinline__ void for_groups(int M, F fn) {
  const Frag f = frag_points();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    if (f.wm * 64 + mt * 16 >= M) continue;  // warp-uniform
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) fn(mt, nt);
  }
}

// Side arrays: per-point vectors that only the thread that wrote them
// reads back (sigmoids, carries), kept per layer in the fragment layout.
// A thread's group (mt, nt) of an M-row layer is one float4, and a warp's
// 32 of them are 512 contiguous bytes; a layer takes roundup(M, 16) rows
// x N floats of device scratch, a tile's share at blockIdx.x.
__device__ __forceinline__ float4* side(float* layer, int M, int mt, int nt) {
  const Frag f = frag_points();
  const int m16 = (M + 15) / 16, g = f.wm * 4 + mt;
  return reinterpret_cast<float4*>(layer + (size_t)blockIdx.x * m16 * 16 * P) +
         ((g * 2 + f.wn) * 4 + nt) * 32 + (threadIdx.x & 31);
}
__device__ __forceinline__ const float4* side(const float* layer, int M,
                                              int mt, int nt) {
  return side(const_cast<float*>(layer), M, mt, nt);
}

// Rows of device scratch a side array of an M-row layer takes.
inline int side_rows(int M) { return (M + 15) / 16 * 16; }

// v0, v1 at points p, p + 1 (p even) of row m of a feature-major (rows, ld)
// array, at the tile's column n0.
__device__ __forceinline__ void store2(float* a, size_t ld, size_t n0, int m,
                                       int p, float v0, float v1) {
  *reinterpret_cast<float2*>(a + (size_t)m * ld + n0 + p) =
      make_float2(v0, v1);
}

// The one-row head layer, forward: out[p] = sum_{k < K} w[k] xs(k, p) in
// fp32 FMA with tier T's operands, four partial sums a point added in a
// fixed order. red holds 4 * P floats; out (P floats, shared) may alias
// red's first row. Syncs.
template <Tier T>
__device__ __forceinline__ void head_dot(const float* __restrict__ w, int K,
                                         const float* xs, float* red,
                                         float* out) {
  const int p = threadIdx.x % P, part = threadIdx.x / P;  // NT = 4 P
  float s = 0.f;
  for (int k = part; k < K; k += NT / P)
    s = fmaf(tier_operand<T>(w[k]), tier_operand<T>(xs[k * SA + p]), s);
  red[part * P + p] = s;
  __syncthreads();
  float v = 0.f;
  if (threadIdx.x < P)
    v = ((red[p] + red[P + p]) + red[2 * P + p]) + red[3 * P + p];
  __syncthreads();
  if (threadIdx.x < P) out[p] = v;
  __syncthreads();
}

// The one-row head layer, transposed: acc(m, p) = w[m] v[p] for m < M with
// tier T's operands, in the per-point fragment layout (so the epilogues of
// tc_product serve it).
template <Tier T>
__device__ __forceinline__ void head_outer(const float* __restrict__ w, int M,
                                           const float* v, Acc& acc) {
  const Frag f = frag_points();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = frag_m(f, mt, e);
        acc[mt][nt][e] = m < M ? tier_operand<T>(w[m]) *
                                     tier_operand<T>(v[frag_p(f, nt, e)])
                               : 0.f;
      }
}

// Shared-memory floats of a per-point kernel: the ring, the tile (act),
// the encoded input and its companion (X, Y), and the head's reductions.
struct TileSmem {
  int ar, xr;  // rows of act and of X / Y
  __host__ __device__ size_t floats() const {
    return (size_t)RING + (size_t)(ar + 2 * xr) * SA + 4 * P + 2 * P;
  }
};

__host__ __device__ inline TileSmem tile_smem(const Layout& lay) {
  return {(lay.smax + KC - 1) / KC * KC, (lay.d0p + KC - 1) / KC * KC};
}

}  // namespace emap
