// Value and spatial gradient of the fused field query at the 3xTF32 tier
// (fp32 accuracy), on Hopper's warpgroup tensor cores (wgmma .tf32) fed by
// TMA.
//
// Replaces: emap_tpu/kernels/mlp_query.py::_pallas_value_and_grad at
// precision "high" and "highest", in both its uses: the extraction query
// of pallas_udf_value_and_grad (kernels/mlp_query.py::value_and_grad_sliced:
// the line-direction and point-shift sweeps of every shipped conf, whose
// model precision is "high"), with f32_residuals=False: the sigmoid
// residuals rounded to bf16 at "high", as the JAX package rounds them; and
// the forward of the training query (emap_tpu/kernels/mlp_train.py::
// _train_query) and the validation chunks when a conf sets field_precision
// "high", with f32_residuals=True. mlp_query.cu keeps the mma.sync design
// of the same tier, which is timed beside this kernel and is on no path.
//
// Computes, per point, what mlp_query.cu computes: the in-kernel PE encode;
// the hidden linears with softplus(100 z)/100 (the skip concat scaled by
// 1/sqrt2) and the abs/square/sdf head; the reverse pass q = W_l^T g
// through every layer down to lin0, times sigmoid(100 z) below each, the x
// rows of the skip layer and all of lin0's rows summed into d udf /
// d x-tilde; the PE Jacobian. Out: udf (n,), grad (8, n) with rows 0-2
// live. Every chain product is fp32-accurate 3xTF32: each operand x split
// into hi = rna(x) and lo = rna(x - hi) (split3, mlp_mma.cuh), lo*hi and
// hi*lo before hi*hi into a fresh accumulator for each 32 contraction
// steps, which is then added to the running sum with a rounded fp32 add
// (the tensor cores add truncating: mlp_mma.cuh). Softplus and sigmoid are
// the exact fp32 forms (sig_softplus100); the head's one-row products are
// fp32 FMA of fp32 operands.
//
// Bound on the H100: operations. 4 sum(in_l out_l) FLOP a point (1.84
// MFLOP at ABC width) at three TF32 passes of 495 TFLOP/s: >= 1.30 ms at
// the training step's 116,736 points, >= 36.5 ms at a 256^3 sweep's
// 3,276,800, against 68 bytes of input and output a point. What the design
// does:
//   * pack_tf32_kernel writes the weights once a launch, pre-split into
//     TF32 hi and lo, in 128-byte rows that TMA loads in its 128-byte
//     swizzle: W as the pack has it (forward products, out rows x in
//     columns) and a transposed copy (reverse products, in rows x out
//     columns), a (512, ldp) fp32 array, hi rows above lo rows, the forward
//     blocks left of the transposed ones (7.9 MB at ABC width, L2-resident).
//     .tf32 wgmma has no transpose bit: both operands in shared memory are
//     K-major, so the reverse products read the transposed copy through
//     the same TMA ring. Within each 8-column group the columns are
//     permuted (tf32_perm), so that an accumulator fragment, stored to the
//     activation tile as the epilogue holds it, loads back as wgmma's A
//     fragment with no shuffle;
//   * a block is 64 points: one producer thread keeps TMA loads of weight
//     chunks (128 outputs x 32 contraction steps, hi and lo: 32 KB) in
//     flight through a 4-stage mbarrier ring, and two consumer warpgroups
//     each compute one 128-wide half of every product's outputs
//     (wgmma m64n128k8; m64n64k8 or m64n40k8 for a narrower half, as
//     lin0's reverse product at d0p 64 or 40), three passes a k8 step;
//   * the activations stay fp32 in one 64-point x 256-feature tile of
//     shared memory, point-major (K-major for A), 64 KB: each consumer
//     loads its A fragments from it, splits them in registers and passes
//     them as wgmma's register operand, so no hi/lo tiles are kept; the
//     product's result stays in the accumulators until both warpgroups
//     have read the tile, then the epilogue writes it over the tile in
//     place. One tile, not an in and an out one: that leaves room for a
//     4-stage ring of fp32 chunks (215,360 of the 232,448 bytes a block
//     may take);
//   * sigmoid(100 z_l) of each hidden layer goes to device scratch in
//     fp32 (f32_residuals=True) or bf16 (False), written and read back by
//     the thread that owns them (the live 8-feature groups only), brought
//     into L2 by one bulk prefetch as the product whose epilogue reads
//     them starts; the x rows of the skip layer's reverse product and
//     lin0's add into an fp32 d udf / d x-tilde block in shared memory,
//     from which a last pass applies the PE Jacobian.
// Launches: pack_tf32_kernel, query_tf32_kernel.

#include "mlp_wgmma.cuh"

using namespace emap;

namespace {

constexpr int T_TILE_BYTES = PW * FMAX * 4;  // 64 points x 256 fp32
constexpr int T_BOX_BYTES = 64 * 32 * 4;     // a 64-row x 32-column box
constexpr int T_HALF_BYTES = 2 * T_BOX_BYTES;  // 128 rows: hi or lo
constexpr int T_STAGE_BYTES = 2 * T_HALF_BYTES;  // hi and lo of a chunk
constexpr int T_STAGES = 4;  // weight ring stages
constexpr int T_CONSUMERS = 2 * WG;
constexpr int GIN_ROWS = 64;  // rows of d udf / d x-tilde: d0p at most
constexpr int T_SMEM = T_STAGES * T_STAGE_BYTES + T_TILE_BYTES +
                       (GIN_ROWS * PW + 4 * PW + PW) * 4 + 2 * T_STAGES * 8 +
                       1024;

__host__ __device__ inline int r32(int x) { return (x + 31) / 32 * 32; }

// The 3xTF32 pack's layout: per layer l < L-1 (the head is fp32 FMA from
// W), its forward block (out_l rows, kf_l = roundup(in_l, 32) columns) at
// column offf_l and its transposed block (in_l rows, kt_l = roundup(out_l,
// 32) columns) at column ldf + offt_l of a (2 FMAX, ldp) fp32 array, hi in
// rows [0, FMAX), lo in [FMAX, 2 FMAX); rows past a block's live ones and
// columns past its contraction are zero.
struct TLayout {
  Layout lay;
  int ldf, ldt, ldp;
  int offf[MAXL], offt[MAXL], kf[MAXL], kt[MAXL];
};

// parse_layout, then what this kernel takes: no layer wider than FMAX,
// each layer's input the last one's output (with the encoded x appended at
// a skip), an encoded input no wider than the d udf / d x-tilde block.
// 0 on success.
int parse_tf32(const int* h, float scale, TLayout* tl) {
  Layout& lay = tl->lay;
  if (parse_layout(h, scale, &lay) || lay.rmax > FMAX || lay.skip[0] ||
      lay.d0p > GIN_ROWS)
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

// The 128-wide halves of a product of N outputs, and the wgmma width of
// half h: its min(128, N - 128 h) outputs rounded up to a wgmma shape of
// this kernel (40, 64 or 128); the rows past the outputs are zero weights.
__host__ __device__ inline int halves(int N) { return (N + 127) / 128; }
__host__ __device__ inline int half_width(int N, int h) {
  const int nh = N - 128 * h < 128 ? N - 128 * h : 128;
  return nh > 64 ? 128 : nh > 40 ? 64 : 40;
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

// Element (r, p) of the d udf / d x-tilde block (GIN_ROWS x PW fp32), the
// point index XOR-swizzled by bits 1-2 of the row: the four rows (two
// apart) and eight points a warp's accumulator element reaches fall on 32
// banks.
__device__ __forceinline__ int gin_at(int r, int p) {
  return r * PW + (p ^ (((r >> 1) & 3) << 3));
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

// Keeps a register fragment's values where they are computed: the
// compiler may not move their computation past this point (a wgmma.fence
// must follow every write of a wgmma's register operand).
__device__ __forceinline__ void pin(unsigned (&a)[4]) {
  asm volatile("" : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3]));
}

// The producer: every weight chunk of the consumers' products, in their
// order: the forward products of layers 0 .. L-2, then the transposed ones
// of L-2 down to 0; within a product, chunk by chunk (32 contraction
// steps), the halves of each chunk in turn. An entry is 64 or 128 rows of
// hi and the same rows of lo.
__device__ void produce_tf32(const CUtensorMap* mp, const TLayout& tl,
                             unsigned char* ring, uint64_t* full,
                             uint64_t* empty) {
  int i = 0;
  auto product = [&](int l, bool trans) {
    const int N = trans ? tl.lay.in[l] : tl.lay.out[l];
    const int K = trans ? tl.kt[l] : tl.kf[l];
    const int col = trans ? tl.ldf + tl.offt[l] : tl.offf[l];
    for (int c = 0; c < K / 32; ++c)
      for (int h = 0; h < halves(N); ++h, ++i) {
        const int stage = i % T_STAGES;
        mbar_wait(&empty[stage], ((i / T_STAGES) & 1) ^ 1);
        const int boxes = half_width(N, h) > 64 ? 2 : 1;
        mbar_expect_tx(&full[stage], 2 * boxes * T_BOX_BYTES);
        unsigned char* dst = ring + stage * T_STAGE_BYTES;
        for (int j = 0; j < boxes; ++j) {
          const int row = 128 * h + 64 * j;
          tma_load(dst + j * T_BOX_BYTES, mp, col + 32 * c, row,
                   &full[stage]);
          tma_load(dst + T_HALF_BYTES + j * T_BOX_BYTES, mp, col + 32 * c,
                   FMAX + row, &full[stage]);
        }
      }
  };
  const int L = tl.lay.L;
  for (int l = 0; l < L - 1; ++l) product(l, false);
  for (int l = L - 2; l >= 0; --l) product(l, true);
}

// acc = half h (width NW) of a product for the block's 64 points: A the
// activation tile's first K features, B the ring's entries `first` + c H +
// h (H halves, chunk c). Each chunk's 4 k8 steps x 3 passes go into part,
// then into acc with a rounded fp32 add.
template <int NW>
__device__ __forceinline__ void product_tf32(float (&acc)[64],
                                             float (&part)[64],
                                             unsigned char* tile,
                                             uint32_t ring, int K, int first,
                                             int H, int h, uint64_t* full,
                                             uint64_t* empty, int t) {
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  const int p = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  for (int c = 0; c < K / 32; ++c) {
    unsigned ah[4][4], al[4][4];
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
    const int i = first + c * H + h, stage = i % T_STAGES;
    mbar_wait(&full[stage], (i / T_STAGES) & 1);
    const uint32_t bh = ring + stage * T_STAGE_BYTES, bl = bh + T_HALF_BYTES;
    // the split fragments computed before the fence, not sunk past it
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      pin(ah[s]);
      pin(al[s]);
    }
    wg_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_tf32<NW>(part, al[s], desc_kmajor(bh, s), s);
      wgmma_tf32<NW>(part, ah[s], desc_kmajor(bl, s), 1);
      wgmma_tf32<NW>(part, ah[s], desc_kmajor(bh, s), 1);
    }
    wg_commit();
    wg_wait0();
    if ((t & 31) == 0) mbar_arrive(&empty[stage]);
#pragma unroll
    for (int i2 = 0; i2 < NW / 2; ++i2) acc[i2] += part[i2];
  }
}

struct QArgs {
  const float* pts;  // (8, n) raw points
  const float* W;    // (rmax, ldw) fp32 pack: the head's row
  const float* B;    // (rmax, L)
  float* udf;        // (n,)
  float* grad;       // (8, n)
  void* side;        // sigmoid side arrays, fp32 or bf16
  long long n;
};

// S: the side arrays' element, float or unsigned short (bf16 bits).
template <typename S>
__global__ void __launch_bounds__(NTW, 1)
    query_tf32_kernel(const __grid_constant__ CUtensorMap mp, QArgs a,
                      TLayout tl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* tile = ring + T_STAGES * T_STAGE_BYTES;
  float* gin = reinterpret_cast<float*>(tile + T_TILE_BYTES);
  float* red = gin + GIN_ROWS * PW;  // [4][p] head partial sums
  float* dyv = red + 4 * PW;         // [p] d udf / d y0
  uint64_t* full = reinterpret_cast<uint64_t*>(dyv + PW);
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
    if (threadIdx.x == 0) produce_tf32(&mp, tl, ring, full, empty);
    return;
  }
  regs_inc<232>();

  const Layout& lay = tl.lay;
  const int L = lay.L;
  // the half of each product's outputs, broadcast from lane 0 so that the
  // compiler sees it warp-uniform (a wgmma in a branch it takes for
  // divergent is serialized)
  const int h = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG - 1, 0);
  const int t = threadIdx.x % WG;
  const int ct = threadIdx.x - WG;  // 0 .. T_CONSUMERS - 1
  const long long p0 = (long long)blockIdx.x * PW;
  const size_t ld = (size_t)a.n;
  const uint32_t ring_addr = smem_u32(ring);
  const float* whead = a.W + lay.off[L - 1];  // the head's one row
  const int pr = 16 * (t >> 5) + ((t & 31) >> 2);  // rows pr, pr + 8
  int first = 0;  // ring entries of the products before this one
  float acc[64], part[64];

  auto csync = [] { named_sync(1, T_CONSUMERS); };
  S* const sides =
      static_cast<S*>(a.side) + (size_t)blockIdx.x * (L - 1) * SIDE;
  auto side = [&](int l) { return sides + (size_t)l * SIDE; };
  // this half's sigmoids of layer l on their way to L2 while the product
  // whose epilogue reads them runs
  auto prefetch = [&](int l) {
    if (t == 0)
      l2_prefetch(side(l) + (size_t)h * 16 * WG * 4, 16 * WG * 4 * sizeof(S));
  };
  auto x_row = [&](int r, int p) {
    return r < lay.d0p ? encode_row(a.pts, ld, (size_t)(p0 + p), r, lay)
                       : 0.f;
  };
  // half h of the product with N outputs over K contraction steps
  auto product = [&](int N, int K) {
    const int H = halves(N);
    if (h < H) {
      const int nw = half_width(N, h);
      if (nw == 128)
        product_tf32<128>(acc, part, tile, ring_addr, K, first, H, h, full,
                          empty, t);
      else if (nw == 64)
        product_tf32<64>(acc, part, tile, ring_addr, K, first, H, h, full,
                         empty, t);
      else
        product_tf32<40>(acc, part, tile, ring_addr, K, first, H, h, full,
                         empty, t);
    }
    first += K / 32 * H;
  };
  // v0, v1 at features f, f + 1 of point p
  auto st2 = [&](int p, int f, float v0, float v1) {
    *reinterpret_cast<float2*>(tile_ptr(tile, p, f)) = make_float2(v0, v1);
  };

  // ---- epilogues of this half (width nw); accumulator element 4 j + e
  // holds point pr + 8 (e >> 1), feature f0 + (e & 1), f0 = 128 h + 8 j +
  // 2 (t % 4) ----
  // forward, layer l: a = softplus(100 z)/100 (x 1/sqrt2 before a skip),
  // s = sigmoid(100 z) to the side array, its live 8-feature groups; at a
  // skip the features from out_l on are the x rows' (fill_x)
  // (branch-free over the features, so the compiler can interleave the
  // elements' math)
  auto epi_forward = [&](int l, int nw) {
    const int M = lay.out[l];
    const bool skip = lay.skip[l + 1] != 0;
    const float scale = skip ? INV_SQRT2 : 1.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (8 * j >= nw) continue;
      const int f0 = 128 * h + 8 * j + 2 * (t & 3);
      float sg[4], act[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + (e & 1);
        const float bias = f < M ? a.B[f * L + l] : 0.f;
        sig_softplus100(acc[4 * j + e] + bias, sg[e], act[e]);
        sg[e] = f < M ? sg[e] : 0.f;
        act[e] = f < M ? act[e] * scale : 0.f;
      }
      if (128 * h + 8 * j < M)
        side_put(side(l), h, j, t, make_float4(sg[0], sg[1], sg[2], sg[3]));
      if (!skip || f0 + 1 < M) {
        st2(pr, f0, act[0], act[1]);
        st2(pr + 8, f0, act[2], act[3]);
      } else if (f0 < M) {
        *tile_ptr(tile, pr, f0) = act[0];
        *tile_ptr(tile, pr + 8, f0) = act[2];
      }
    }
  };
  // reverse, layer l >= 1: q = W_l^T g_l; g_{l-1} = q (x 1/sqrt2 at a
  // skip) * s_{l-1} on the c = out_{l-1} features below the x rows, which
  // (at a skip) add to d udf / d x-tilde
  auto epi_grad = [&](int l, int nw) {
    const int c = lay.out[l - 1], M = lay.in[l];
    const bool skip = lay.skip[l] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (8 * j >= nw) continue;
      const int f0 = 128 * h + 8 * j + 2 * (t & 3);
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (128 * h + 8 * j < c) sv = side_get(side(l - 1), h, j, t);
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = f0 + (e & 1), p = pr + 8 * (e >> 1);
        const float qv = acc[4 * j + e];
        const float carry = skip ? qv * INV_SQRT2 : qv;
        v[e] = f < c ? carry * sg[e] : 0.f;
        if (skip && f >= c && f < M) gin[gin_at(f - c, p)] += carry;
      }
      st2(pr, f0, v[0], v[1]);
      st2(pr + 8, f0, v[2], v[3]);
    }
  };
  // reverse, lin0: every feature of q = W_0^T g_0 adds to d udf / d x-tilde
  auto epi_input = [&](int nw) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (8 * j >= nw) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 8 * j + 2 * (t & 3) + (e & 1), p = pr + 8 * (e >> 1);
        if (f < lay.in[0]) gin[gin_at(f, p)] += acc[4 * j + e];
      }
    }
  };
  // features [from, to) of every point: x (x 1/sqrt2 past the first
  // layer), 0 past d0p
  auto fill_x = [&](int from, int to, float scale) {
    for (int i = ct; i < (to - from) * PW; i += T_CONSUMERS) {
      const int p = i / (to - from), f = from + i % (to - from);
      *tile_ptr(tile, p, f) = x_row(f - from, p) * scale;
    }
  };

  // x = PE(points): layer 0's input, zeros up to the tile's width
  fill_x(0, FMAX, 1.f);
  for (int i = ct; i < GIN_ROWS * PW; i += T_CONSUMERS) gin[i] = 0.f;
  csync();

  // forward: u_{l+1} over u_l in the tile, s_l to the side arrays
  for (int l = 0; l < L - 1; ++l) {
    product(lay.out[l], tl.kf[l]);
    csync();  // both halves have read the tile
    if (h < halves(lay.out[l])) epi_forward(l, half_width(lay.out[l], h));
    if (lay.skip[l + 1]) fill_x(lay.out[l], tl.kf[l + 1], INV_SQRT2);
    csync();
  }
  // the head: y0 = w . u_{L-1} + b; udf, and dy = d udf / d y0
  {
    const int p = ct % PW, part4 = ct / PW;
    float s = 0.f;
    for (int f = part4; f < lay.in[L - 1]; f += 4)
      s = fmaf(whead[f], *tile_ptr(tile, p, f), s);
    red[part4 * PW + p] = s;
    csync();
    if (ct < PW) {
      const float y0 =
          (((red[p] + red[PW + p]) + red[2 * PW + p]) + red[3 * PW + p]) +
          a.B[L - 1];
      float u, dy;
      if (lay.udf_type == 0) {
        u = fabsf(y0);
        dy = sign_of(y0);
      } else if (lay.udf_type == 1) {
        u = y0 * y0;
        dy = 2.f * y0;
      } else {
        u = y0;
        dy = 1.f;
      }
      a.udf[p0 + p] = u / lay.scale;
      dyv[p] = dy / lay.scale;
    }
    csync();
  }

  // reverse: the head's transposed product acc = w[f] dy[p], then W_l^T
  // down to lin0
  {
    const int N = lay.in[L - 1];
    if (h < halves(N)) {
      const int nw = half_width(N, h);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 128 * h + 8 * j + 2 * (t & 3) + (e & 1);
          acc[4 * j + e] = f < N ? whead[f] * dyv[pr + 8 * (e >> 1)] : 0.f;
        }
      epi_grad(L - 1, nw);
    }
    csync();
  }
  for (int l = L - 2; l >= 1; --l) {
    prefetch(l - 1);
    product(lay.in[l], tl.kt[l]);
    csync();
    if (h < halves(lay.in[l])) epi_grad(l, half_width(lay.in[l], h));
    csync();
  }
  product(lay.in[0], tl.kt[0]);
  if (h < halves(lay.in[0])) epi_input(half_width(lay.in[0], h));
  csync();

  // PE Jacobian: du_j = g_j + sum_k f_k (cos(u_j f_k) gs - sin(u_j f_k) gc)
  const int mr = lay.multires;
  for (int i = ct; i < 8 * PW; i += T_CONSUMERS) {
    const int r = i / PW, p = i % PW;
    const size_t n = (size_t)(p0 + p);
    float v = 0.f;
    if (r < 3) {
      float du = gin[gin_at(r, p)];
      for (int k = 0; k < mr; ++k) {
        const float f = (float)(1 << k);
        const float uf = a.pts[(size_t)r * ld + n] * lay.scale * f;
        const float gs = gin[gin_at(3 + 3 * k + r, p)];
        const float gc = gin[gin_at(3 + 3 * mr + 3 * k + r, p)];
        du = du + f * (cosf(uf) * gs - sinf(uf) * gc);
      }
      v = du * lay.scale;
    }
    a.grad[(size_t)r * ld + n] = v;
  }
}

// The prologue, W (rmax, ldw) fp32 -> the 3xTF32 pack (2 FMAX, ldp): each
// element of a layer's forward or transposed block, at its permuted
// column, split into hi = rna(w) and lo = rna(w - hi).
__global__ void pack_tf32_kernel(const float* __restrict__ W,
                                 float* __restrict__ pk, TLayout tl) {
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

// A map of the (2 FMAX, cols) fp32 pack with 64-row x 32-column boxes (128
// bytes a row) in the 128-byte swizzle. 0 on success.
int f32_box_map(CUtensorMap* map, void* base, long long rows,
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

// Scratch the wrapper allocates, by kernels/mlp_query.py::query_tf32_plan.
struct Sizes {
  long long pack, side, smem, blocks;
};

Sizes sizes_of(const TLayout& tl, long long n) {
  Sizes s;
  s.blocks = (n + PW - 1) / PW;
  s.pack = (long long)2 * FMAX * tl.ldp;
  s.side = s.blocks * (tl.lay.L - 1) * (long long)SIDE;
  s.smem = T_SMEM;
  return s;
}

}  // namespace

extern "C" {

// The scratch and shared memory of a launch at n points: out[0] pack
// floats, [1] side-array elements, [2] the query kernel's dynamic shared
// bytes, [3] its blocks. 0 on success, 1 on a layout the kernels do not
// take.
int emap_mlp_query_tf32_sizes(const int* layout, long long n,
                              long long* out) {
  TLayout tl;
  if (parse_tf32(layout, 1.f, &tl) || n <= 0) return 1;
  const Sizes s = sizes_of(tl, n);
  const long long v[4] = {s.pack, s.side, s.smem, s.blocks};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,), grad (8, n); fp32,
// contiguous, on the device; n a multiple of 64; tier TF32X3. Scratch as
// emap_mlp_query_tf32_sizes gives it: pack (fp32), side (fp32, or bf16
// when bf16_side: the sigmoid residuals rounded to bf16). Returns
// cudaErrorInvalidValue on anything else or a tensor map
// cuTensorMapEncodeTiled refuses, else the first nonzero CUDA error (the
// shared-memory opt-in, each launch).
int emap_mlp_query_tf32(const float* pts, const float* W, const float* B,
                        float* udf, float* grad, float* pack, void* side,
                        long long n, const int* layout, float scale,
                        int tier, int bf16_side, void* stream) {
  TLayout tl;
  if (parse_tf32(layout, scale, &tl) || n <= 0 || n % PW || tier != TF32X3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Sizes sz = sizes_of(tl, n);
  CUtensorMap mp;
  if (f32_box_map(&mp, pack, 2 * FMAX, tl.ldp))
    return (int)cudaErrorInvalidValue;
  const auto kernel = bf16_side ? query_tf32_kernel<unsigned short>
                                : query_tf32_kernel<float>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T_SMEM);
  if (err) return err;

  pack_tf32_kernel<<<132, 256, 0, st>>>(W, pack, tl);
  err = (int)cudaGetLastError();
  if (err) return err;

  QArgs args{pts, W, B, udf, grad, side, n};
  kernel<<<(unsigned)sz.blocks, NTW, T_SMEM, st>>>(mp, args, tl);
  return (int)cudaGetLastError();
}

}  // extern "C"
