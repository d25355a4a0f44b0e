// Second-order backward of the fused training field query at the pairs of
// tiers with a 3xTF32 tier, on Hopper's warpgroup tensor cores (wgmma) fed
// by TMA.
//
// Replaces: emap_tpu/kernels/mlp_train.py::_pallas_train_bwd with
// fuse_pe=True (per-tile math in _train_bwd_math) at the (3xTF32, 3xTF32)
// pair (field_precision "high"), the mixed (3xTF32, bf16) pair (adding
// bwd_precision "default") and the (bf16, 3xTF32) pair (field_precision
// "default", bwd_precision "high"); mlp_train_wgmma.cu runs the (bf16,
// bf16) pair of the shipped confs, and mlp_train.cu keeps the mma.sync
// design of every pair, timed beside these kernels and on no path. As
// mlp_train_wgmma.cu does, it recomputes the forward from the raw points,
// reruns the spatial-gradient chain at the primal tier TP, runs the
// ascend/descend adjoint chains at the adjoint tier TA (kernels/
// mlp_train.py, module docstring) and sums the packed weight and bias
// gradients over all points. A 3xTF32 product is fp32-accurate: each
// operand split into TF32 hi and lo, lo*hi and hi*lo before hi*hi (mlp_
// tf32.cuh); a bf16 product rounds both operands to bf16 (to nearest even,
// as tier_dot) with fp32 sums. The head's one-row products are fp32 FMA of
// the tier's operands.
//
// Bound on the H100: operations. 12 sum(in_l out_l) - 4 in_0 out_0 FLOP a
// point (kernels/mlp_train.py::train_bwd_flops) at three TF32 passes of 495
// TFLOP/s: >= 3.85 ms at the step's 116,736 points at ABC width at the
// 3xTF32 pair, >= 1.71 ms at the mixed pair (its adjoint half at bf16).
// What the design does:
//   * the prologue writes the weights once a launch: the 3xTF32 pack
//     (pack_tf32_kernel: W and W^T pre-split into hi and lo, mlp_tf32.cuh),
//     which serves all four chains at 3xTF32 (forward and ascend read the
//     forward blocks, gradient and descend the transposed ones), and at a
//     bf16 tier the bf16 pack (pack_kernel, mlp_wgmma.cuh), read K-major
//     or MN-major through wgmma's transpose bit;
//   * the per-point kernel (train_tf32_kernel) is a block of 64 points: one
//     producer thread keeps TMA loads of the chains' weight chunks in
//     flight through a 4-stage ring of 32 KB (3xTF32: 128 outputs x 32
//     steps, hi and lo; bf16: 128 outputs x 64 steps), and two consumer
//     warpgroups each compute one 128-wide half of every product's outputs
//     (wgmma m64n128; a narrower net's half reads zero weight rows past
//     its outputs);
//   * the activations stay fp32 in one 64-point x 256-feature tile of
//     shared memory (mlp_tf32.cuh: tile_at), read by both chains' tiers:
//     each consumer loads its A fragments from it and splits them into
//     TF32 hi and lo, or rounds them to bf16 pairs, in registers, and passes
//     them as wgmma's register operand; a product's result stays in the
//     accumulators until both warpgroups have read the tile, then the
//     epilogue writes it over the tile in place;
//   * the epilogue also stores it to device memory as the weight-gradient
//     factor (U_l, Q-hat_l, R_l, Z-hat_l in wgmma_layout's rows, feature-
//     major: a warp's store is 8 consecutive points of 4 features), fp32
//     at a 3xTF32 adjoint, bf16 at a bf16 one (the rounding tier_dot gives
//     the same operands); sigmoid(100 z_l) and carry_{l+1}, then s-hat_l,
//     stay fp32 in device side arrays that the thread that owns them writes
//     and reads back (mlp_wgmma.cuh: side_slot), brought into L2 by one
//     bulk prefetch as the product whose epilogue reads them starts; the
//     bias gradient sums z-hat in fp32 before any rounding, a partial a
//     block;
//   * the weight gradient W-bar_l = R_l Q-hat_l^T + Z-hat_l U_l^T runs over
//     KS fixed point ranges: at a 3xTF32 adjoint on wbar_tf32_kernel (TMA
//     loads of 32-point chunks of both fp32 factors, K-major as .tf32
//     needs; three producer warps split the B chunk into hi and lo in
//     shared memory while the consumers split A in registers), at a bf16
//     one on mlp_train_gemm.cuh's wbar_kernel; reduce_kernel sums the
//     range partials and the blocks' bias partials in a fixed order. No
//     atomics: two launches on the same inputs agree bit for bit.
// Sums: every 32-deep (3xTF32) or 64-deep (bf16) chunk of a contraction
// goes into a fresh accumulator that is then added to the running fp32 sum
// (the tensor cores add truncating: mlp_mma.cuh), in the chains and the
// GEMMs alike.
// Launches: pack_tf32_kernel, pack_kernel (a bf16 tier only),
// train_tf32_kernel, wbar_tf32_kernel or wbar_kernel, reduce_kernel.

#include "mlp_tf32.cuh"
#include "mlp_train_gemm.cuh"

using namespace emap;

namespace {

constexpr int T_HALF_BYTES = 2 * T_BOX_BYTES;    // 128 rows: hi or lo
constexpr int T_STAGE_BYTES = 2 * T_HALF_BYTES;  // a ring entry
constexpr int T_STAGES = 4;                      // weight ring stages
constexpr int T_CONSUMERS = 2 * WG;
// bias sums: [half][warp][128 features]
constexpr int BSUM_FLOATS = 2 * 4 * 128;
constexpr int TT_SMEM = T_STAGES * T_STAGE_BYTES + T_TILE_BYTES +
                        (BSUM_FLOATS + 3 * PW + 4 * PW) * 4 +
                        2 * T_STAGES * 8 + 1024;
// the 3xTF32 GEMM: a stage is 32 points of 128 rows of each factor (fp32,
// the ring entry's two halves), and the B rows' lo half beside it
constexpr int TG_SPLITTERS = 3;  // producer warps that split B
constexpr int TG_SMEM = T_STAGES * (T_STAGE_BYTES + T_HALF_BYTES) +
                        3 * T_STAGES * 8 + 1024;

// A tier as a type, so that a lambda's tier argument is a constant.
template <Tier T>
struct At {
  static constexpr Tier tier = T;
};

// Both views of the layout: the 3xTF32 pack's blocks and the bf16 pack's
// and factors' (WLayout).
struct TrLayout {
  TLayout tl;
  WLayout wl;
};

int parse_train(const int* h, float scale, TrLayout* x) {
  return parse_tf32(h, scale, &x->tl) || parse_wgmma(h, scale, &x->wl);
}

// The 128-wide halves of a product of N outputs.
__host__ __device__ inline int halves(int N) { return (N + 127) / 128; }

// The contraction depth of a chain product of layer l at tier T: the
// forward (and ascend) products contract in_l, the transposed ones out_l,
// rounded up to a 3xTF32 chunk (32) or a bf16 one (64).
__host__ __device__ inline int depth(const TrLayout& x, Tier T, int l,
                                     bool trans) {
  if (T == TF32X3) return trans ? x.tl.kt[l] : x.tl.kf[l];
  return trans ? x.wl.opad[l] : x.wl.kpad[l];
}

// The producer: every weight chunk of the consumers' chain products, in
// their order (forward and gradient at TP, ascend and descend at TA);
// within a product, chunk by chunk, the halves of each chunk in turn. A
// 3xTF32 entry is 128 rows of hi and the same rows of lo (the pack's
// forward or transposed block); a bf16 entry two 64 x 64 boxes of the bf16
// pack (forward: outputs 128 h + 64 j, columns 64 c of the block;
// transposed: rows 64 c, columns 128 h + 64 j).
template <Tier TP, Tier TA>
__device__ void produce_train(const CUtensorMap* mp, const CUtensorMap* mw,
                              const TrLayout& x, unsigned char* ring,
                              uint64_t* full, uint64_t* empty) {
  const Layout& lay = x.tl.lay;
  int i = 0;
  auto product = [&](int l, bool trans, Tier T) {
    const int N = trans ? lay.in[l] : lay.out[l];
    const int K = depth(x, T, l, trans);
    const int kc = T == TF32X3 ? 32 : 64;
    for (int c = 0; c < K / kc; ++c)
      for (int h = 0; h < halves(N); ++h, ++i) {
        const int stage = i % T_STAGES;
        mbar_wait(&empty[stage], ((i / T_STAGES) & 1) ^ 1);
        unsigned char* dst = ring + stage * T_STAGE_BYTES;
        if (T == TF32X3) {
          const int col = trans ? x.tl.ldf + x.tl.offt[l] : x.tl.offf[l];
          mbar_expect_tx(&full[stage], 2 * T_HALF_BYTES);
          tma_entry(dst, mp, col + 32 * c, 128 * h, 2, T_HALF_BYTES,
                    &full[stage]);
        } else {
          mbar_expect_tx(&full[stage], 2 * BOX_BYTES);
          for (int j = 0; j < 2; ++j) {
            const int cx = x.wl.offb[l] + (trans ? 128 * h + 64 * j : 64 * c);
            const int cy = trans ? 64 * c : 128 * h + 64 * j;
            tma_load(dst + j * BOX_BYTES, mw, cx, cy, &full[stage]);
          }
        }
      }
  };
  const int L = lay.L;
  for (int l = 0; l < L - 1; ++l) product(l, false, TP);
  for (int l = L - 2; l >= 1; --l) product(l, true, TP);
  for (int l = 0; l < L - 1; ++l) product(l, false, TA);
  for (int l = L - 2; l >= 1; --l) product(l, true, TA);
}

// acc = half h of a 3xTF32 product for the block's 64 points: A the
// activation tile's first K features, split into hi and lo in registers, B
// the ring's entries `first` + c H + h (H halves, chunk c). Each chunk's 4
// k8 steps x 3 passes go into part, then into acc with a rounded fp32 add.
__device__ __forceinline__ void product_tf32(float (&acc)[64],
                                             float (&part)[64],
                                             unsigned char* tile,
                                             uint32_t ring, int K, int first,
                                             int H, int h, uint64_t* full,
                                             uint64_t* empty, int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int p = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  for (int c = 0; c < K / 32; ++c) {
    unsigned ah[4][4], al[4][4];
    split_a_chunk(tile, p, q, c, ah, al);
    const int i = first + c * H + h, stage = i % T_STAGES;
    mbar_wait(&full[stage], (i / T_STAGES) & 1);
    const uint32_t bh = ring + stage * T_STAGE_BYTES, bl = bh + T_HALF_BYTES;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      pin(ah[s]);
      pin(al[s]);
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32<128>(part, al[s], desc_kmajor(bh, s), s);
      wgmma_tf32<128>(part, ah[s], desc_kmajor(bl, s), 1);
      wgmma_tf32<128>(part, ah[s], desc_kmajor(bh, s), 1);
    }
    wg_commit();
    wg_wait0();
    if ((t & 31) == 0) mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) acc[i2] += part[i2];
  }
}

// d (+)= A B over one k16 step, m64 n128, bf16 operands: A from registers
// (a[i] of warp w, lane q: row 16 w + q / 4 + 8 (i & 1), k positions 2 (q
// % 4) + 8 (i >> 1) and the next, the lower in the low half), B from
// shared memory, K-major or (TB) MN-major; fp32 accumulators in
// wgmma_m64n128's layout; d is zeroed first when !accumulate.
template <int TB>
__device__ __forceinline__ void wgmma_bf16_ra(float (&d)[64],
                                              const unsigned (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
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
        "r"(accumulate), "n"(TB));
}

// acc = half h (128 wide) of a bf16 product for the block's 64 points: A
// the activation tile's first K features rounded to bf16 pairs in
// registers (the features 16 s + 2 (t % 4) + {0, 1} and 8 more of a k16
// step s: the pairs an accumulator fragment of the thread holds, so a
// thread reads only what it wrote), B the ring's entries `first` + c H + h
// (64-deep chunks of the bf16 pack, K-major, or MN-major when TB). Each
// chunk's 4 k16 steps go into part, then into acc with a rounded fp32 add.
template <int TB>
__device__ __forceinline__ void product_bf16(float (&acc)[64],
                                             float (&part)[64],
                                             unsigned char* tile,
                                             uint32_t ring, int K, int first,
                                             int H, int h, uint64_t* full,
                                             uint64_t* empty, int t) {
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int p = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  for (int c = 0; c < K / 64; ++c) {
    unsigned a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int f = 64 * c + 16 * s + 2 * q;
      const float2 v0 = *reinterpret_cast<const float2*>(tile_ptr(tile, p, f));
      const float2 v1 =
          *reinterpret_cast<const float2*>(tile_ptr(tile, p + 8, f));
      const float2 v2 =
          *reinterpret_cast<const float2*>(tile_ptr(tile, p, f + 8));
      const float2 v3 =
          *reinterpret_cast<const float2*>(tile_ptr(tile, p + 8, f + 8));
      a[s][0] = bf16x2(v0.x, v0.y);
      a[s][1] = bf16x2(v1.x, v1.y);
      a[s][2] = bf16x2(v2.x, v2.y);
      a[s][3] = bf16x2(v3.x, v3.y);
    }
    const int i = first + c * H + h, stage = i % T_STAGES;
    mbar_wait(&full[stage], (i / T_STAGES) & 1);
    const uint32_t b = ring + stage * T_STAGE_BYTES;
#pragma unroll
    for (int s = 0; s < 4; ++s) pin(a[s]);
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
      wgmma_bf16_ra<TB>(part, a[s],
                        TB ? desc_mnmajor(b, s) : desc_kmajor(b, s), s);
    wg_commit();
    wg_wait0();
    if ((t & 31) == 0) mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) acc[i2] += part[i2];
  }
}

// The factors' element at a tier: fp32, or bf16 bits at BF16.
template <Tier T>
struct FactorOf {
  using type = float;
};
template <>
struct FactorOf<BF16> {
  using type = unsigned short;
};

// *p = v (rounded to bf16 for an unsigned short p) where keep: one
// predicated store, no branch.
__device__ __forceinline__ void st_if(float* p, float v, bool keep) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n"
      ::"l"(p), "f"(v), "r"((int)keep));
}
__device__ __forceinline__ void st_if(unsigned short* p, float v, bool keep) {
  asm volatile(
      "{\n.reg .pred q;\n.reg .b16 b;\nsetp.ne.b32 q, %2, 0;\n"
      "cvt.rn.bf16.f32 b, %1;\n@q st.global.b16 [%0], b;\n}\n"
      ::"l"(p), "f"(v), "r"((int)keep));
}

struct TArgs {
  const float* pts;   // (8, n) raw points
  const float* W;     // (rmax, ldw) fp32 pack: the head's row
  const float* B;     // (rmax, L)
  const float* ubar;  // (n,)
  const float* gbar;  // (8, n)
  float* side;        // side arrays
  float* bpart;       // (blocks, rmax, L) bias partials
  void* F;            // (frows, n) factors: fp32, or bf16 bits at TA BF16
  long long n;
};

template <Tier TP, Tier TA>
__global__ void __launch_bounds__(NTW, 1)
    train_tf32_kernel(const __grid_constant__ CUtensorMap mp,
                      const __grid_constant__ CUtensorMap mw, TArgs a,
                      TrLayout x) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* tile = ring + T_STAGES * T_STAGE_BYTES;
  float* bsum = reinterpret_cast<float*>(tile + T_TILE_BYTES);
  float* dyv = bsum + BSUM_FLOATS;  // [p] d udf / d y0
  float* zhv = dyv + PW;            // [p] z-hat_{L-1}
  float* rhv = zhv + PW;            // [p] r-hat_{L-1}
  float* red = rhv + PW;            // [4][p] head partial sums
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 4 * PW);
  uint64_t* empty = full + T_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a warp of its consumer
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < WG) {
    regs_dec<40>();
    if (threadIdx.x == 0)
      produce_train<TP, TA>(&mp, &mw, x, ring, full, empty);
    return;
  }
  regs_inc<232>();

  const WLayout& wl = x.wl;
  const Layout& lay = x.tl.lay;
  const int L = lay.L, rmax = lay.rmax;
  // the half of each product's outputs, broadcast from lane 0 so that the
  // compiler sees it warp-uniform (a wgmma in a branch it takes for
  // divergent is serialized)
  const int h = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG - 1, 0);
  const int t = threadIdx.x % WG, w = t >> 5, lane = t & 31;
  const int ct = threadIdx.x - WG;  // 0 .. T_CONSUMERS - 1
  const long long p0 = (long long)blockIdx.x * PW;
  const size_t ld = (size_t)a.n;
  const uint32_t ring_addr = smem_u32(ring);
  const float* whead = a.W + lay.off[L - 1];  // the head's one row
  const int pr = 16 * w + (lane >> 2);        // rows pr, pr + 8
  int first = 0;  // ring entries of the products before this one
  float acc[64], part[64];

  auto csync = [] { named_sync(1, T_CONSUMERS); };
  float* const sides = a.side + (size_t)blockIdx.x * (L - 1) * 2 * SIDE;
  // the side array kind (0 sigmoid, 1 carry / s-hat) of layer l
  auto side = [&](int l, int kind) {
    return sides + (size_t)(2 * l + kind) * SIDE;
  };
  // this half's part of it on its way to L2 while the product whose
  // epilogue reads it runs
  auto prefetch = [&](int l, int kind) {
    if (t == 0)
      l2_prefetch(side(l, kind) + (size_t)h * 16 * WG * 4, 16 * WG * 16);
  };
  // the factors from this block's first point on
  typename FactorOf<TA>::type* const fac =
      static_cast<typename FactorOf<TA>::type*>(a.F) + p0;
  // factor row `row` + f of point p, where keep
  auto put = [&](int row, int f, int p, float v, bool keep) {
    st_if(fac + (size_t)(row + f) * ld + p, v, keep);
  };
  auto x_row = [&](int r, int p) {
    return r < lay.d0p ? encode_row(a.pts, ld, (size_t)(p0 + p), r, lay)
                       : 0.f;
  };
  auto gb_row = [&](int r, int p) {
    return r < lay.d0p
               ? pe_jacT_row(a.pts, a.gbar, ld, (size_t)(p0 + p), r, lay)
               : 0.f;
  };
  // features [from, to) of every point: v(f - from, p) * scale, and the
  // factor rows row + f of those below `live`
  auto fill = [&](int from, int to, int live, int row, float scale,
                  auto v) {
    for (int i = ct; i < (to - from) * PW; i += T_CONSUMERS) {
      const int f = from + i / PW, p = i % PW;
      const float val = v(f - from, p) * scale;
      *tile_ptr(tile, p, f) = val;
      put(row, f, p, val, f < live);
    }
  };
  const At<TP> tp;
  const At<TA> ta;
  // half h of a chain product of layer l at tier at, its result in acc
  auto product = [&](int l, bool trans, auto at) {
    constexpr Tier T = decltype(at)::tier;
    const int N = trans ? lay.in[l] : lay.out[l];
    const int K = depth(x, T, l, trans), H = halves(N);
    if (h < H) {
      if constexpr (T == BF16) {
        if (trans)
          product_bf16<1>(acc, part, tile, ring_addr, K, first, H, h, full,
                          empty, t);
        else
          product_bf16<0>(acc, part, tile, ring_addr, K, first, H, h, full,
                          empty, t);
      } else {
        product_tf32(acc, part, tile, ring_addr, K, first, H, h, full, empty,
                     t);
      }
    }
    first += K / (T == TF32X3 ? 32 : 64) * H;
  };
  // v0, v1 at features f, f + 1 of point p
  auto st2 = [&](int p, int f, float v0, float v1) {
    *reinterpret_cast<float2*>(tile_ptr(tile, p, f)) = make_float2(v0, v1);
  };
  // the tile's features f0, f0 + 1 of points pr, pr + 8 from v; at a skip
  // only those below M (the x rows above them are the fill's)
  auto st_half = [&](int f0, int M, bool skip, const float (&v)[4]) {
    if (!skip || f0 + 1 < M) {
      st2(pr, f0, v[0], v[1]);
      st2(pr + 8, f0, v[2], v[3]);
    } else if (f0 < M) {
      *tile_ptr(tile, pr, f0) = v[0];
      *tile_ptr(tile, pr + 8, f0) = v[2];
    }
  };
  // the factor rows row + f0 and row + f0 + 1 of points pr, pr + 8 from
  // v, those where keep0 and keep1; past a factor's live rows its padding
  // rows take v's zeros
  auto put_half = [&](int row, int f0, bool keep0, bool keep1,
                      const float (&v)[4]) {
    auto* r0 = fac + (size_t)(row + f0) * ld + pr;
    st_if(r0, v[0], keep0);
    st_if(r0 + 8, v[2], keep0);
    st_if(r0 + ld, v[1], keep1);
    st_if(r0 + ld + 8, v[3], keep1);
  };

  // ---- epilogues of this half; accumulator element 4 j + e
  // holds point pr + 8 (e >> 1), feature f0 + (e & 1), f0 = 128 h + 8 j +
  // 2 (t % 4); side arrays only for the live 8-feature groups ----
  // forward, layer l: a = softplus(100 z)/100 (x 1/sqrt2 before a skip), U_l+1;
  // s = sigmoid(100 z) to the side array
  auto epi_forward = [&](int l) {
    const int M = lay.out[l];
    const bool skip = lay.skip[l + 1] != 0;
    const float scale = skip ? INV_SQRT2 : 1.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int f0 = 128 * h + 8 * j + 2 * (t & 3);
      const bool live = 128 * h + 8 * j < M;
      float sg[4], act[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + (e & 1);
        const float bias = f < M ? a.B[f * L + l] : 0.f;
        sig_softplus100(acc[4 * j + e] + bias, sg[e], act[e]);
        sg[e] = f < M ? sg[e] : 0.f;
        act[e] = f < M ? act[e] * scale : 0.f;
      }
      st_half(f0, M, skip, act);
      if (live) {
        side_put(side(l, 0), h, j, t,
                 make_float4(sg[0], sg[1], sg[2], sg[3]));
        put_half(wl.rowU[l + 1], f0, !skip || f0 < M, !skip || f0 + 1 < M,
                 act);
      }
    }
  };
  // gradient chain, layer l: carry = the non-x rows of q = W_l^T r_l
  // (scaled at a skip) to the side array; r_{l-1} = carry * s_{l-1}, R_l-1
  auto epi_grad = [&](int l) {
    const int c = lay.out[l - 1];
    const bool skip = lay.skip[l] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int f0 = 128 * h + 8 * j + 2 * (t & 3);
      const bool live = 128 * h + 8 * j < c;
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) sv = side_get(side(l - 1, 0), h, j, t);
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      float ch[4], v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + (e & 1);
        const float qv = acc[4 * j + e];
        const float carry = skip ? qv * INV_SQRT2 : qv;
        ch[e] = f < c ? carry : 0.f;
        v[e] = f < c ? carry * sg[e] : 0.f;
      }
      st_half(f0, c, false, v);
      if (live) {
        side_put(side(l - 1, 1), h, j, t,
                 make_float4(ch[0], ch[1], ch[2], ch[3]));
        put_half(wl.rowR[l - 1], f0, true, true, v);
      }
    }
  };
  // ascend, layer l: s-hat_l = r-hat * carry_{l+1} (over the carry);
  // q-hat_{l+1} = r-hat * s_l (x 1/sqrt2 before a skip), Q-hat_l+1
  auto epi_ascend = [&](int l) {
    const int M = lay.out[l];
    const bool skip = lay.skip[l + 1] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int f0 = 128 * h + 8 * j + 2 * (t & 3);
      const bool live = 128 * h + 8 * j < M;
      float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), sv = cv;
      if (live) {
        cv = side_get(side(l, 1), h, j, t);
        sv = side_get(side(l, 0), h, j, t);
      }
      const float carry[4] = {cv.x, cv.y, cv.z, cv.w};
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      float sh[4], qh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + (e & 1);
        const float r = acc[4 * j + e];
        const float chv = r * sg[e];
        sh[e] = f < M ? r * carry[e] : 0.f;
        qh[e] = f < M ? (skip ? chv * INV_SQRT2 : chv) : 0.f;
      }
      st_half(f0, M, skip, qh);
      if (live) {
        side_put(side(l, 1), h, j, t,
                 make_float4(sh[0], sh[1], sh[2], sh[3]));
        put_half(wl.rowQ[l + 1], f0, !skip || f0 < M, !skip || f0 + 1 < M,
                 qh);
      }
    }
  };
  // descend, layer l: a-hat = the non-x rows of u-hat (scaled at a skip),
  // z-hat_{l-1} = a-hat * s + s-hat * (100 s (1 - s)), Z-hat_l-1; the bias
  // sums of the warp's 16 points into bsum
  auto epi_descend = [&](int l) {
    const int c = lay.out[l - 1];
    const bool skip = lay.skip[l] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int f0 = 128 * h + 8 * j + 2 * (t & 3);
      const bool live = 128 * h + 8 * j < c;
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f), hv = sv;
      if (live) {
        sv = side_get(side(l - 1, 0), h, j, t);
        hv = side_get(side(l - 1, 1), h, j, t);
      }
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      const float sh[4] = {hv.x, hv.y, hv.z, hv.w};
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + (e & 1);
        const float uh = acc[4 * j + e];
        const float av = skip ? uh * INV_SQRT2 : uh;
        z[e] = f < c ? av * sg[e] + sh[e] * ((100.f * sg[e]) * (1.f - sg[e]))
                     : 0.f;
      }
      st_half(f0, c, false, z);
      if (live) put_half(wl.rowZ[l - 1], f0, true, true, z);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = z[e] + z[e + 2];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) bsum[(h * 4 + w) * 128 + 8 * j + 2 * lane + e] = v;
      }
    }
  };
  // b-bar_lb of the block's 64 points: the 4 warps' sums of each half in
  // a fixed order
  auto bias_flush = [&](int lb) {
    csync();
    if (ct < rmax) {
      float v = 0.f;
      if (ct < lay.out[lb])
        for (int k = 0; k < 4; ++k)
          v += bsum[((ct >> 7) * 4 + k) * 128 + (ct & 127)];
      a.bpart[(size_t)blockIdx.x * rmax * L + (size_t)ct * L + lb] = v;
    }
    csync();
  };
  // the head's dot w . tile over in_{L-1} features at tier at, four
  // partial sums a point added in a fixed order; out[p] = sum + bias
  auto head_dot = [&](float* out, float bias, auto at) {
    constexpr Tier T = decltype(at)::tier;
    const int p = ct % PW, part4 = ct / PW;
    float s = 0.f;
    for (int f = part4; f < lay.in[L - 1]; f += 4) {
      const float wv = whead[f], xv = *tile_ptr(tile, p, f);
      s = fmaf(tier_operand<T>(wv), tier_operand<T>(xv), s);
    }
    red[part4 * PW + p] = s;
    csync();
    if (ct < PW)
      out[p] = (((red[p] + red[PW + p]) + red[2 * PW + p]) + red[3 * PW + p]) +
               bias;
    csync();
  };
  // the head's transposed product, this half: acc = w[f] v[p] at tier at
  // for the features f < in_{L-1}, 0 past them
  auto head_outer = [&](const float* v, auto at) {
    constexpr Tier T = decltype(at)::tier;
    const int N = lay.in[L - 1];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 128 * h + 8 * j + 2 * (t & 3) + (e & 1);
        const float wv = f < N ? whead[f] : 0.f, pv = v[pr + 8 * (e >> 1)];
        acc[4 * j + e] = tier_operand<T>(wv) * tier_operand<T>(pv);
      }
  };

  // x = PE(points): layer 0's input and U_0, zeros up to the tile's width
  fill(0, FMAX, lay.in[0], wl.rowU[0], 1.f, x_row);
  csync();

  // forward recompute: u_{l+1} over u_l in the tile, U_{l+1}; s_l to the
  // side arrays
  for (int l = 0; l < L - 1; ++l) {
    product(l, false, tp);
    csync();  // both halves have read the tile
    if (h < halves(lay.out[l])) epi_forward(l);
    if (lay.skip[l + 1])
      fill(lay.out[l], wl.kpad[l + 1], lay.in[l + 1], wl.rowU[l + 1],
           INV_SQRT2, x_row);
    csync();
  }
  // the head: y0 = w . u_{L-1} + b, dy = d udf / d y0; R_{L-1} = dy
  head_dot(dyv, a.B[L - 1], tp);
  if (ct < PW) {
    const float y0 = dyv[ct];
    float dy;
    if (lay.udf_type == 0) dy = sign_of(y0) / lay.scale;
    else if (lay.udf_type == 1) dy = 2.f * y0 / lay.scale;
    else dy = 1.f / lay.scale;
    dyv[ct] = dy;
    put(wl.rowR[L - 1], 0, ct, dy, true);
  }
  csync();

  // spatial-gradient chain: q = W_l^T r_l; R_{l-1}
  if (h < halves(lay.in[L - 1])) {
    head_outer(dyv, tp);
    epi_grad(L - 1);
  }
  csync();
  for (int l = L - 2; l >= 1; --l) {
    prefetch(l - 1, 0);
    product(l, true, tp);
    csync();
    if (h < halves(lay.in[l])) epi_grad(l);
    csync();
  }

  // ascend: q-hat_0 = (dPE/dx)^T gbar, Q-hat_0, then r-hat = W_l q-hat_l;
  // Q-hat_{l+1}
  fill(0, FMAX, lay.in[0], wl.rowQ[0], 1.f, gb_row);
  csync();
  for (int l = 0; l < L - 1; ++l) {
    prefetch(l, 0);
    prefetch(l, 1);
    product(l, false, ta);
    csync();
    if (h < halves(lay.out[l])) epi_ascend(l);
    if (lay.skip[l + 1])
      fill(lay.out[l], wl.kpad[l + 1], lay.in[l + 1], wl.rowQ[l + 1],
           INV_SQRT2, gb_row);
    csync();
  }
  head_dot(rhv, 0.f, ta);

  // descend: z-hat_{L-1} = ubar * dy (+ r-hat * 2/scale, square head),
  // Z-hat_{L-1} and b-bar_{L-1}; then u-hat = W_l^T z-hat_l; Z-hat_{l-1}
  // and the bias partials
  if (ct < PW) {
    float z = a.ubar[p0 + ct] * dyv[ct];
    if (lay.udf_type == 1) z = z + rhv[ct] * (2.f / lay.scale);
    zhv[ct] = z;
    put(wl.rowZ[L - 1], 0, ct, z, true);
  }
  csync();
  if (ct < rmax) {
    float v = 0.f;
    if (ct == 0)  // the block's z-hat_{L-1}, its points in order
      for (int p = 0; p < PW; ++p) v += zhv[p];
    a.bpart[(size_t)blockIdx.x * rmax * L + (size_t)ct * L + L - 1] = v;
  }
  if (h < halves(lay.in[L - 1])) {
    head_outer(zhv, ta);
    epi_descend(L - 1);
  }
  bias_flush(L - 2);
  for (int l = L - 2; l >= 1; --l) {
    prefetch(l - 1, 0);
    prefetch(l - 1, 1);
    product(l, true, ta);
    csync();
    if (h < halves(lay.in[l])) epi_descend(l);
    bias_flush(l - 1);
  }
}

// ---- the weight-gradient GEMM over fp32 factors -------------------------

// Per (tile, point range): wpart[range][o][off_l + i] = sum over the range
// of R_l[o] Q-hat_l[i] + Z-hat_l[o] U_l[i] at 3xTF32. The producer thread
// loads a 32-point chunk of 128 factor rows of each operand a stage (A: R or
// Z-hat, B: Q-hat or U; K-major, 64-row x 32-point boxes in the 128-byte
// swizzle); three producer warps then split B in place into TF32 hi and a
// lo copy beside it; consumer c splits its rows [64 c, 64 c + 64) of A in
// registers and passes them as wgmma's register operand.
__global__ void __launch_bounds__(NTW, 1)
    wbar_tf32_kernel(const __grid_constant__ CUtensorMap mf, WLayout wl,
                     GTiles tiles, long long n, long long chunk,
                     float* wpart) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* lo = ring + T_STAGES * T_STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(lo + T_STAGES * T_HALF_BYTES);
  uint64_t* split = full + T_STAGES;
  uint64_t* empty = split + T_STAGES;
  const GTile tl = tiles.t[blockIdx.x];
  const long long nb = (long long)blockIdx.y * chunk;
  const long long ne = nb + chunk < n ? nb + chunk : n;
  const int nch = nb < ne ? (int)((ne - nb + 31) / 32) : 0;
  const int total = 2 * nch;  // (R, Q-hat) chunks, then (Z-hat, U)

  if (threadIdx.x == 0) {
    for (int s = 0; s < T_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&split[s], TG_SPLITTERS);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < WG) {
    regs_dec<40>();
    const int warp = threadIdx.x >> 5;
    if (threadIdx.x == 0) {
      for (int c = 0; c < total; ++c) {
        const int stage = c % T_STAGES;
        mbar_wait(&empty[stage], ((c / T_STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[stage], T_STAGE_BYTES);
        unsigned char* dst = ring + stage * T_STAGE_BYTES;
        const bool second = c >= nch;
        const int px = (int)(nb + 32LL * (second ? c - nch : c));
        const int ra = (second ? wl.rowZ : wl.rowR)[tl.l] + tl.o0;
        const int rb = (second ? wl.rowU : wl.rowQ)[tl.l] + tl.i0;
        for (int j = 0; j < 2; ++j) {
          tma_load(dst + j * T_BOX_BYTES, &mf, px, ra + 64 * j, &full[stage]);
          tma_load(dst + T_HALF_BYTES + j * T_BOX_BYTES, &mf, px,
                   rb + 64 * j, &full[stage]);
        }
      }
    } else if (warp >= 1) {
      for (int c = 0; c < total; ++c) {
        const int stage = c % T_STAGES;
        mbar_wait(&full[stage], (c / T_STAGES) & 1);
        float4* b = reinterpret_cast<float4*>(ring + stage * T_STAGE_BYTES +
                                              T_HALF_BYTES);
        float4* bl = reinterpret_cast<float4*>(lo + stage * T_HALF_BYTES);
        for (int i = threadIdx.x - 32; i < T_HALF_BYTES / 16;
             i += 32 * TG_SPLITTERS) {
          const float4 v = b[i];
          unsigned hx, hy, hz, hw, lx, ly, lz, lw;
          split3(v.x, hx, lx);
          split3(v.y, hy, ly);
          split3(v.z, hz, lz);
          split3(v.w, hw, lw);
          b[i] = make_float4(__uint_as_float(hx), __uint_as_float(hy),
                             __uint_as_float(hz), __uint_as_float(hw));
          bl[i] = make_float4(__uint_as_float(lx), __uint_as_float(ly),
                              __uint_as_float(lz), __uint_as_float(lw));
        }
        // the split visible to wgmma's operand reads
        fence_async_smem();
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(&split[stage]);
      }
    }
    return;
  }
  regs_inc<232>();

  const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG - 1, 0);
  const int t = threadIdx.x % WG, w = t >> 5, q = t & 31;
  const int g = 16 * w + (q >> 2), k4 = q & 3;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int c = 0; c < total; ++c) {
    const int stage = c % T_STAGES;
    const unsigned parity = (c / T_STAGES) & 1;
    mbar_wait(&full[stage], parity);
    mbar_wait(&split[stage], parity);
    // A(r, k): row r of this consumer's box, point k of the chunk
    const unsigned char* abox =
        ring + stage * T_STAGE_BYTES + cw * T_BOX_BYTES;
    auto a_at = [&](int r, int k) {
      return *reinterpret_cast<const float*>(
          abox + r * 128 + ((((k >> 2) ^ (r & 7)) << 4) | ((k & 3) << 2)));
    };
    unsigned ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = 8 * s + k4;
      split3(a_at(g, k), ah[s][0], al[s][0]);
      split3(a_at(g + 8, k), ah[s][1], al[s][1]);
      split3(a_at(g, k + 4), ah[s][2], al[s][2]);
      split3(a_at(g + 8, k + 4), ah[s][3], al[s][3]);
    }
    const uint32_t bh = smem_u32(ring + stage * T_STAGE_BYTES + T_HALF_BYTES);
    const uint32_t bl = smem_u32(lo + stage * T_HALF_BYTES);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      pin(ah[s]);
      pin(al[s]);
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32<128>(part, al[s], desc_kmajor(bh, s), s);
      wgmma_tf32<128>(part, ah[s], desc_kmajor(bl, s), 1);
      wgmma_tf32<128>(part, ah[s], desc_kmajor(bh, s), 1);
    }
    wg_commit();
    wg_wait0();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
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

// Scratch the wrapper allocates, by kernels/mlp_train.py::train_tf32_plan.
struct Sizes {
  long long pack, wb, frows, side, partials, pp_smem, g_smem, blocks;
};

Sizes sizes_of(const TrLayout& x, long long n, int tier, int adjoint_tier) {
  const Layout& lay = x.tl.lay;
  Sizes s;
  s.blocks = (n + PW - 1) / PW;
  s.pack = (long long)2 * FMAX * x.tl.ldp;
  s.wb = tier == BF16 || adjoint_tier == BF16 ? (long long)FMAX * x.wl.ldwb
                                              : 0;
  s.frows = x.wl.frows;
  s.side = s.blocks * (lay.L - 1) * 2LL * SIDE;
  s.partials = (long long)KS * lay.rmax * lay.ldw +
               s.blocks * lay.rmax * lay.L;
  s.pp_smem = TT_SMEM;
  s.g_smem = adjoint_tier == BF16 ? G_SMEM : TG_SMEM;
  return s;
}

// The pairs these kernels run: at least one tier 3xTF32.
bool pair_ok(int tier, int adjoint_tier) {
  return (tier == TF32X3 || tier == BF16) &&
         (adjoint_tier == TF32X3 || adjoint_tier == BF16) &&
         !(tier == BF16 && adjoint_tier == BF16);
}

template <Tier TP, Tier TA>
int launch(const CUtensorMap& mp, const CUtensorMap& mw,
           const CUtensorMap& mf, const TArgs& args, const TrLayout& x,
           float* wpart, float* bpart, float* wbar, float* bbar,
           const Sizes& sz, long long n, cudaStream_t st) {
  int err = (int)cudaFuncSetAttribute(
      train_tf32_kernel<TP, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TT_SMEM);
  if (!err)
    err = TA == BF16 ? (int)cudaFuncSetAttribute(
                           wbar_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM)
                     : (int)cudaFuncSetAttribute(
                           wbar_tf32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           TG_SMEM);
  if (err) return err;
  train_tf32_kernel<TP, TA><<<(unsigned)sz.blocks, NTW, TT_SMEM, st>>>(
      mp, mw, args, x);
  err = (int)cudaGetLastError();
  if (err) return err;

  const GTiles tiles = gemm_tiles(x.tl.lay);
  const long long chunk = gemm_chunk(n);
  if (TA == BF16)
    wbar_kernel<<<dim3(tiles.count, KS), NTW, G_SMEM, st>>>(mf, x.wl, tiles,
                                                            n, chunk, wpart);
  else
    wbar_tf32_kernel<<<dim3(tiles.count, KS), NTW, TG_SMEM, st>>>(
        mf, x.wl, tiles, n, chunk, wpart);
  err = (int)cudaGetLastError();
  if (err) return err;

  const int wblocks = 264;
  reduce_kernel<<<wblocks + 64, 256, 0, st>>>(wpart, bpart, wbar, bbar, x.wl,
                                              (int)sz.blocks, wblocks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The scratch and shared memory of a launch at n points and a pair of
// tiers: out[0] 3xTF32 pack floats, [1] bf16 pack elements (0 without a
// bf16 tier), [2] factor rows (x n fp32 at a 3xTF32 adjoint, bf16 at a
// bf16 one), [3] side-array floats, [4] partial floats, [5] and [6] the
// per-point and GEMM kernels' dynamic shared bytes, [7] per-point blocks.
// 0 on success, 1 on a layout or pair the kernels do not take.
int emap_mlp_train_tf32_sizes(const int* layout, long long n, int tier,
                              int adjoint_tier, long long* out) {
  TrLayout x;
  if (parse_train(layout, 1.f, &x) || n <= 0 || !pair_ok(tier, adjoint_tier))
    return 1;
  const Sizes s = sizes_of(x, n, tier, adjoint_tier);
  const long long v[8] = {s.pack, s.wb, s.frows, s.side, s.partials,
                          s.pp_smem, s.g_smem, s.blocks};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

// pts (8, n), W (rmax, ldw), B (rmax, L), ubar (n,), gbar (8, n) -> wbar
// (rmax, ldw), bbar (rmax, L); fp32, contiguous, on the device; n a
// multiple of 64; tier (primal) and adjoint_tier Tier codes, one of them
// TF32X3. Scratch as emap_mlp_train_tf32_sizes gives it: pack (fp32), wb
// (bf16; unread without a bf16 tier), factors (fp32, or bf16 at a bf16
// adjoint), side and partials (fp32). Returns cudaErrorInvalidValue on
// anything else or a tensor map cuTensorMapEncodeTiled refuses, else the
// first nonzero CUDA error (the shared-memory opt-ins, each launch).
int emap_mlp_train_tf32(const float* pts, const float* W, const float* B,
                        const float* ubar, const float* gbar, float* wbar,
                        float* bbar, float* pack, void* wb, void* factors,
                        float* side, float* partials, long long n,
                        const int* layout, float scale, int tier,
                        int adjoint_tier, void* stream) {
  TrLayout x;
  if (parse_train(layout, scale, &x) || n <= 0 || n % PW ||
      !pair_ok(tier, adjoint_tier))
    return (int)cudaErrorInvalidValue;
  const Layout& lay = x.tl.lay;
  const cudaStream_t st = (cudaStream_t)stream;
  const Sizes sz = sizes_of(x, n, tier, adjoint_tier);
  const bool bf16 = sz.wb > 0;
  CUtensorMap mp, mw{}, mf;  // mw unread without a bf16 tier
  if (f32_box_map(&mp, pack, 2 * FMAX, x.tl.ldp) ||
      (bf16 && bf16_box_map(&mw, wb, FMAX, x.wl.ldwb)) ||
      (adjoint_tier == BF16 ? bf16_box_map(&mf, factors, x.wl.frows, n)
                            : f32_box_map(&mf, factors, x.wl.frows, n)))
    return (int)cudaErrorInvalidValue;

  pack_tf32_kernel<<<132, 256, 0, st>>>(W, pack, x.tl);
  int err = (int)cudaGetLastError();
  if (err) return err;
  if (bf16) {
    pack_kernel<<<132, 256, 0, st>>>(W, (unsigned short*)wb, x.wl);
    err = (int)cudaGetLastError();
    if (err) return err;
  }

  float* wpart = partials;
  float* bpart = partials + (size_t)KS * lay.rmax * lay.ldw;
  const TArgs args{pts, W, B, ubar, gbar, side, bpart, factors, n};
  if (tier == TF32X3 && adjoint_tier == TF32X3)
    return launch<TF32X3, TF32X3>(mp, mw, mf, args, x, wpart, bpart, wbar,
                                  bbar, sz, n, st);
  if (tier == TF32X3)
    return launch<TF32X3, BF16>(mp, mw, mf, args, x, wpart, bpart, wbar, bbar,
                                sz, n, st);
  return launch<BF16, TF32X3>(mp, mw, mf, args, x, wpart, bpart, wbar, bbar,
                              sz, n, st);
}

}  // extern "C"
