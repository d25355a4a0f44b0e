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

#include "mlp_tf32.cuh"

using namespace emap;

namespace {

constexpr int T_HALF_BYTES = 2 * T_BOX_BYTES;  // 128 rows: hi or lo
constexpr int T_STAGE_BYTES = 2 * T_HALF_BYTES;  // hi and lo of a chunk
constexpr int T_STAGES = 4;  // weight ring stages
constexpr int T_CONSUMERS = 2 * WG;
constexpr int GIN_ROWS = 64;  // rows of d udf / d x-tilde: d0p at most
constexpr int T_SMEM = T_STAGES * T_STAGE_BYTES + T_TILE_BYTES +
                       (GIN_ROWS * PW + 4 * PW + PW) * 4 + 2 * T_STAGES * 8 +
                       1024;

// parse_tf32, and an encoded input no wider than the d udf / d x-tilde
// block. 0 on success.
int parse_query(const int* h, float scale, TLayout* tl) {
  return parse_tf32(h, scale, tl) || tl->lay.d0p > GIN_ROWS;
}

// The 128-wide halves of a product of N outputs, and the wgmma width of
// half h: its min(128, N - 128 h) outputs rounded up to a wgmma shape of
// this kernel (40, 64 or 128); the rows past the outputs are zero weights.
__host__ __device__ inline int halves(int N) { return (N + 127) / 128; }
__host__ __device__ inline int half_width(int N, int h) {
  const int nh = N - 128 * h < 128 ? N - 128 * h : 128;
  return nh > 64 ? 128 : nh > 40 ? 64 : 40;
}

// Element (r, p) of the d udf / d x-tilde block (GIN_ROWS x PW fp32), the
// point index XOR-swizzled by bits 1-2 of the row: the four rows (two
// apart) and eight points a warp's accumulator element reaches fall on 32
// banks.
__device__ __forceinline__ int gin_at(int r, int p) {
  return r * PW + (p ^ (((r >> 1) & 3) << 3));
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
        tma_entry(ring + stage * T_STAGE_BYTES, mp, col + 32 * c, 128 * h,
                  boxes, T_HALF_BYTES, &full[stage]);
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
    split_a_chunk(tile, p, q, c, ah, al);
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
  if (parse_query(layout, 1.f, &tl) || n <= 0) return 1;
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
  if (parse_query(layout, scale, &tl) || n <= 0 || n % PW || tier != TF32X3)
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
