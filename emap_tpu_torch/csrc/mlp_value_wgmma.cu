// Fused UDF field query, value only, at the bf16 tier: the dense extraction
// grid and the threshold selector's certify probe at a "default" model
// precision, on Hopper's warpgroup tensor cores (wgmma) fed by TMA.
//
// Replaces: emap_tpu/kernels/mlp_query.py::_pallas_value at precision
// "default" (pallas_udf_value, from the grid pass of
// emap_tpu/extract/pointcloud.py and the probe of
// emap_tpu/extract/autothresh.py). mlp_value_tf32.cu takes the 3xTF32
// tier; mlp_value.cu keeps the mma.sync design of both tiers, which is
// timed beside this kernel and is on no path.
//
// Computes, per point, what kernels/mlp_query.py::value_plain computes at
// "default": the in-kernel PE encode; the hidden linears on bf16-rounded
// weights and activations with fp32 sums, each 64-deep chunk into a fresh
// accumulator that is added to the running sum (the tensor cores add
// truncating: mlp_mma.cuh); fp32 bias, softplus(100 z)/100 (the skip
// concat scaled by 1/sqrt2); the head's one row as fp32 FMA of
// bf16-rounded operands; the abs/square/sdf head, divided by scale. Out:
// udf (n,).
//
// Bound on the H100: operations. 2 sum(in_l out_l) FLOP a point (0.92
// MFLOP at ABC width) at 989 TFLOP/s: >= 1.95 ms a 128^3 pass (2,097,152
// points), >= 3.89 ms a 256^3 chunk, against 36 bytes of input and output
// a point. Two more floors of this design lie near the products' own
// (kernels/mlp_query.py::value_wgmma_launch_costs):
//   * the epilogue: 1,985 softplus a point at ABC width, each two
//     operations of the special function unit (ex2, lg2), which does 16 a
//     clock an SM: 2.15 ms a 128^3 pass at 1.83 GHz;
//   * the weight stream: every hidden layer's bf16 chunks (950,272 bytes at
//     ABC width) from L2 once for each 128 points, 15.6 GB a 128^3 pass.
// What the design does:
//   * pack_kernel (mlp_wgmma.cuh) rounds W to the engine's bf16 pack once a
//     launch; one producer thread keeps TMA loads of 64 x 128 weight chunks
//     in flight through a 4-stage mbarrier ring, in the consumers' order;
//   * a persistent grid, one block an SM, walks pairs of 64-point tiles:
//     each of two consumer warpgroups takes one tile of the pair through
//     every layer, so each weight chunk serves 128 points. Both read the
//     one ring, each at its own pace within its 4 chunks (one 128-wide
//     half at K = 256). Turns at the tensor cores (one's products beside
//     the other's epilogue), a fifth stage and a halved weight stream
//     measured no gain: the epilogue's special function unit and other
//     instructions and the products add up (scripts/torch_kernel_ablation.py
//     value_wgmma_*);
//   * the activations stay bf16 in shared memory, two tiles a consumer,
//     point-major (wgmma's A K-major: four 64-feature boxes of 128-byte
//     rows), so a thread stores the two neighbouring features its
//     accumulator holds for a point as one 32-bit word;
//   * a product's 128-wide half runs as wgmma m64n128k16, its first 64-deep
//     chunk straight into the running sum, each later one into a fresh
//     accumulator then added to it;
//   * the epilogue reads the bias pre-scaled by 100 log2(e) from shared
//     memory (-1e30 past a layer's outputs, where the softplus then comes
//     out exactly 0 with no compare) and takes the softplus from the
//     special function unit: with u = 100 log2(e) z, softplus(100 z)/100 =
//     (max(u, 0) + lg2(1 + ex2(-|u|))) ln2 / 100, within 3e-9 of the exact
//     value besides u's own fp32 rounding (lg2.approx's 2^-22 and the
//     rounding of 1 + e, times ln2 / 100), far below the bf16 rounding the
//     activation meets next;
//   * the last hidden layer's activations never reach a tile: the head's
//     dot is summed in registers from them against the head's row (rounded
//     to bf16, in shared memory), the four threads of a quad adding their
//     sums by shuffles.
// 214,080 bytes of shared memory: the ring, four 32 KB activation tiles,
// the biases of up to 15 hidden layers, the head's row, the mbarriers and
// 1 KB of alignment. Launches: pack_kernel, value_wgmma_kernel.

#include "mlp_wgmma.cuh"

using namespace emap;

namespace {

constexpr int V_LAYERS = MAXL - 1;  // hidden layers the bias table holds
constexpr int V_SMEM = STAGES * STAGE_BYTES + 4 * TILE_BYTES +
                       (V_LAYERS * FMAX + FMAX) * 4 + 2 * STAGES * 8 + 1024;
constexpr float LOG2E_100 = 144.269504f;  // 100 log2(e)
constexpr float LN2_100 = 0.0069314718f;  // ln(2) / 100
constexpr float PAST_OUT = -1e30f;        // the bias table past out_l

// parse_wgmma, and a head whose input is the last hidden layer's output
// alone (no skip at the head). 0 on success.
int parse_value(const int* h, float scale, WLayout* wl) {
  return parse_wgmma(h, scale, wl) || wl->lay.skip[wl->lay.L - 1];
}

struct VArgs {
  const float* pts;  // (8, n) raw points
  const float* W;    // (rmax, ldw) fp32 pack: the head's row
  const float* B;    // (rmax, L)
  float* udf;        // (n,)
  long long n, pairs;
};

// Byte offset of (point p, feature f) in a point-major activation tile:
// four 64-feature boxes of 64 rows of 128 bytes, in the 128-byte swizzle.
__device__ __forceinline__ uint32_t kswz(int p, int f) {
  return (uint32_t)((f >> 6) * BOX_BYTES) + swz(p, f & 63);
}

__device__ __forceinline__ void st_k(unsigned char* tile, int p, int f,
                                     float x) {
  *reinterpret_cast<unsigned short*>(tile + kswz(p, f)) = bf16_bits(x);
}

// lo and hi rounded to bf16 (to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// softplus(100 z)/100 (x 1/sqrt2 ahead of a skip) from u = 100 log2(e) z:
// (max(u, 0) + lg2(1 + ex2(-|u|))) c, with c = ln2 / 100 (x 1/sqrt2).
// ex2.approx and lg2.approx are the special function unit's (lg2 within
// 2^-22 absolute); 1 + e rounds e to a multiple of 2^-23. Together within
// 3e-9 of the exact value, besides u's own fp32 rounding; 0 at u = -1e30
// (past a layer's outputs).
__device__ __forceinline__ float softplus_u(float u, float c) {
  float e, lg;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-fabsf(u)));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(1.f + e));
  return (fmaxf(u, 0.f) + lg) * c;
}

// The producer: every weight chunk of the consumers' products, in their
// order, two 64 x 64 boxes a stage: per pair of tiles of the block (first,
// first + step, ...) the forward products of layers 0 .. L-2, per product
// its 128-wide halves, per half its 64-deep chunks.
__device__ void produce_value(const CUtensorMap* mw, const WLayout& wl,
                              long long pairs, long long first,
                              long long step, unsigned char* ring,
                              uint64_t* full, uint64_t* empty) {
  int stage = 0;
  unsigned phase = 0;
  const int L = wl.lay.L;
  for (long long tt = first; tt < pairs; tt += step)
    for (int l = 0; l < L - 1; ++l) {
      int N, K;
      prod_shape(wl, l, false, N, K);
      for (int h = 0; h * 128 < N; ++h)
        for (int c = 0; c < K / 64; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* dst = ring + stage * STAGE_BYTES;
          for (int j = 0; j < 2; ++j)
            tma_load(dst + j * BOX_BYTES, mw, wl.offb[l] + 64 * c,
                     128 * h + 64 * j, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
}

// One 64-deep chunk of a product half into d (overwritten): A the
// point-major tile's box at a (K-major), B the ring's next stage (K-major).
__device__ __forceinline__ void chunk_into(float (&d)[64], uint32_t a,
                                           uint32_t ring, int& stage,
                                           unsigned& phase, uint64_t* full,
                                           uint64_t* empty) {
  mbar_wait(&full[stage], phase);
  const uint32_t b = ring + stage * STAGE_BYTES;
  wg_fence();
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_m64n128<0, 0>(d, desc_kmajor(a, s), desc_kmajor(b, s), s);
  wg_commit();
  wg_wait0();
  if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[stage]);
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// acc = one 128-wide half of a product for the warpgroup's 64 points over
// a K-deep contraction: the first chunk straight into acc, each later one
// into part, then into acc with a rounded fp32 add.
__device__ __forceinline__ void half_product(float (&acc)[64],
                                             float (&part)[64],
                                             uint32_t a_addr, uint32_t ring,
                                             int K, int& stage,
                                             unsigned& phase, uint64_t* full,
                                             uint64_t* empty) {
  chunk_into(acc, a_addr, ring, stage, phase, full, empty);
  for (int c = 1; c < K / 64; ++c) {
    chunk_into(part, a_addr + c * BOX_BYTES, ring, stage, phase, full, empty);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }
}

template <int MODE>
struct Mode {
  static constexpr int value = MODE;
};

__global__ void __launch_bounds__(NTW, 1)
    value_wgmma_kernel(const __grid_constant__ CUtensorMap mw, VArgs a,
                       WLayout wl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* tiles = ring + STAGES * STAGE_BYTES;
  // [l][f]: 100 log2(e) b_l[f], PAST_OUT from out_l on
  float* bias = reinterpret_cast<float*>(tiles + 4 * TILE_BYTES);
  float* whead = bias + V_LAYERS * FMAX;  // bf16-rounded, 0 past its input
  uint64_t* full = reinterpret_cast<uint64_t*>(whead + FMAX);
  uint64_t* empty = full + STAGES;

  const Layout& lay = wl.lay;
  const int L = lay.L;
  for (int i = threadIdx.x; i < (L - 1) * FMAX; i += NTW) {
    const int l = i / FMAX, f = i % FMAX;
    bias[i] = f < lay.out[l] ? a.B[f * L + l] * LOG2E_100 : PAST_OUT;
  }
  for (int f = threadIdx.x; f < FMAX; f += NTW)
    whead[f] = f < lay.in[L - 1]
                   ? tier_operand<BF16>(a.W[lay.off[L - 1] + f])
                   : 0.f;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < WG) {
    regs_dec<40>();
    if (threadIdx.x == 0)
      produce_value(&mw, wl, a.pairs, blockIdx.x, gridDim.x, ring, full,
                    empty);
    return;
  }
  regs_inc<232>();

  // the consumer, broadcast from lane 0 so that the compiler sees it
  // warp-uniform (a wgmma in a branch it takes for divergent is serialized)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG - 1, 0);
  const int t = threadIdx.x % WG;
  // this thread's points p, p + 8 of the tile and its features 8 j + 2 q +
  // {0, 1} of each 8-feature group (wgmma_m64n128's accumulator layout)
  const int p = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  // kswz(p, 2 q) but for the XOR of the 8-feature group into bits 4-6:
  // kswz(p, 64 b + 8 g + 2 q) = (b BOX_BYTES + koff) ^ (g << 4)
  const uint32_t koff = p * ROW_BYTES + ((p & 7) << 4) + 4 * q;
  const uint32_t ring_addr = smem_u32(ring);
  const size_t ld = (size_t)a.n;
  unsigned char* cur = tiles + 2 * wg * TILE_BYTES;
  unsigned char* nxt = cur + TILE_BYTES;
  int stage = 0;
  unsigned phase = 0;
  long long p0 = 0;
  bool valid = false;
  float acc[64], part[64];

  auto wg_sync = [&] { named_sync(1 + wg, WG); };
  // nxt's writes visible to wgmma; nxt becomes cur
  auto publish = [&] {
    fence_async_smem();
    wg_sync();
    unsigned char* s = cur;
    cur = nxt;
    nxt = s;
  };
  // features [from, to) of nxt: the encoded x of the tile's points (rows
  // 0 .. d0-1 of the blocked PE, kernels/mlp_query.py::encode_fused) x
  // scale, then zeros; zeros past n. sin and cos of one argument together.
  auto fill_x = [&](int from, int to, float scale) {
    const int m = lay.multires;
    for (int i = t; i < (3 + 3 * m) * PW; i += WG) {
      const int c = i / PW, pt = i % PW;
      const size_t n = (size_t)(p0 + pt);
      if (c < 3) {
        st_k(nxt, pt, from + c,
             valid ? a.pts[(size_t)c * ld + n] * lay.scale * scale : 0.f);
      } else {
        const int k = (c - 3) / 3, j = (c - 3) % 3;
        float sn = 0.f, cs = 0.f;
        if (valid)
          sincosf(a.pts[(size_t)j * ld + n] * lay.scale * (float)(1 << k),
                  &sn, &cs);
        st_k(nxt, pt, from + 3 + 3 * k + j, sn * scale);
        st_k(nxt, pt, from + 3 + 3 * m + 3 * k + j, cs * scale);
      }
    }
    for (int i = t; i < (to - from - lay.d0) * PW; i += WG)
      st_k(nxt, i % PW, from + lay.d0 + i / PW, 0.f);
  };
  // the epilogue of half h of hidden layer l, softplus scaled by c: this
  // thread's pairs of features into nxt as 32-bit words (Mode<0>); below
  // the skip's x rows, which fill_x has written from out_l on (Mode<1>: the
  // pair that straddles out_l stores its live half alone); or, at the last
  // hidden layer, into the head's dot s for points p, p + 8 (Mode<2>)
  auto epilogue = [&](auto mode, int l, int h, float c, float (&s)[2]) {
    constexpr int MODE = decltype(mode)::value;
    const int M = lay.out[l];
    const float* bl = bias + l * FMAX + 128 * h + 2 * q;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 b2 = *reinterpret_cast<const float2*>(bl + 8 * j);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = softplus_u(
            fmaf(acc[4 * j + e], LOG2E_100, (e & 1) ? b2.y : b2.x), c);
      const uint32_t w0 = bf16x2(v[0], v[1]), w1 = bf16x2(v[2], v[3]);
      const int f = 128 * h + 8 * j + 2 * q;
      if constexpr (MODE == 2) {
        const float2 wh = *reinterpret_cast<const float2*>(whead + f);
        s[0] = fmaf(wh.x, __uint_as_float(w0 << 16), s[0]);
        s[0] = fmaf(wh.y, __uint_as_float(w0 & 0xffff0000u), s[0]);
        s[1] = fmaf(wh.x, __uint_as_float(w1 << 16), s[1]);
        s[1] = fmaf(wh.y, __uint_as_float(w1 & 0xffff0000u), s[1]);
      } else {
        const uint32_t off =
            ((2 * h + (j >> 3)) * BOX_BYTES + koff) ^ ((j & 7) << 4);
        unsigned char* r0 = nxt + off;
        unsigned char* r1 = r0 + 8 * ROW_BYTES;  // point p + 8
        if (MODE == 0 || f + 1 < M) {
          *reinterpret_cast<uint32_t*>(r0) = w0;
          *reinterpret_cast<uint32_t*>(r1) = w1;
        } else if (f < M) {
          *reinterpret_cast<unsigned short*>(r0) = (unsigned short)w0;
          *reinterpret_cast<unsigned short*>(r1) = (unsigned short)w1;
        }
      }
    }
  };

  for (long long tt = blockIdx.x; tt < a.pairs; tt += gridDim.x) {
    p0 = (2 * tt + wg) * PW;
    valid = p0 < a.n;  // a ragged N leaves the last pair's second empty
    // x = PE(points): layer 0's input, zeros up to its contraction
    fill_x(0, wl.kpad[0], 1.f);
    publish();
    float s[2] = {0.f, 0.f};
    for (int l = 0; l < L - 1; ++l) {
      int N, K;
      prod_shape(wl, l, false, N, K);
      const bool skip = lay.skip[l + 1] != 0, head = l == L - 2;
      const float c = skip ? LN2_100 * INV_SQRT2 : LN2_100;
      // at a skip the features from out_l on are x / sqrt2
      if (skip) fill_x(lay.out[l], wl.kpad[l + 1], INV_SQRT2);
      for (int h = 0; h * 128 < N; ++h) {
        half_product(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                     full, empty);
        if (head)
          epilogue(Mode<2>{}, l, h, c, s);
        else if (skip)
          epilogue(Mode<1>{}, l, h, c, s);
        else
          epilogue(Mode<0>{}, l, h, c, s);
      }
      if (!head) publish();
    }
    // the head: the quad's sums, y0 = w . u_{L-1} + b; udf = |y0|, y0^2 or
    // y0, / scale
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 1);
      s[k] += __shfl_xor_sync(0xffffffffu, s[k], 2);
    }
    if (valid && q == 0) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float y0 = s[k] + a.B[L - 1];
        const float u = lay.udf_type == 0   ? fabsf(y0)
                        : lay.udf_type == 1 ? y0 * y0
                                            : y0;
        a.udf[p0 + p + 8 * k] = u / lay.scale;
      }
    }
  }
}

// Scratch and launch shape, by kernels/mlp_query.py::value_wgmma_plan.
struct Sizes {
  long long wb, smem, blocks, tiles;
};

int sizes_of(const WLayout& wl, long long n, Sizes* s) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      sms <= 0)
    return 1;
  s->tiles = (n + PW - 1) / PW;
  const long long pairs = (s->tiles + 1) / 2;
  s->blocks = pairs < sms ? pairs : sms;
  s->wb = (long long)FMAX * wl.ldwb;
  s->smem = V_SMEM;
  return 0;
}

}  // namespace

extern "C" {

// The scratch and launch shape at n points on the current device: out[0]
// bf16 weight-pack elements, [1] the value kernel's dynamic shared bytes,
// [2] its blocks, [3] its 64-point tiles. 0 on success, 1 on a layout the
// kernels do not take.
int emap_mlp_value_wgmma_sizes(const int* layout, long long n,
                               long long* out) {
  WLayout wl;
  Sizes s;
  if (parse_value(layout, 1.f, &wl) || n <= 0 || sizes_of(wl, n, &s))
    return 1;
  const long long v[4] = {s.wb, s.smem, s.blocks, s.tiles};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,); fp32, contiguous, on
// the device; n a multiple of 64; tier BF16. wb: the bf16 pack, as
// emap_mlp_value_wgmma_sizes sizes it. Returns cudaErrorInvalidValue on
// anything else or a tensor map cuTensorMapEncodeTiled refuses, else the
// first nonzero CUDA error (the shared-memory opt-in, each launch).
int emap_mlp_value_wgmma(const float* pts, const float* W, const float* B,
                         float* udf, void* wb, long long n,
                         const int* layout, float scale, int tier,
                         void* stream) {
  WLayout wl;
  Sizes sz;
  if (parse_value(layout, scale, &wl) || n <= 0 || n % PW || tier != BF16 ||
      sizes_of(wl, n, &sz))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap mw;
  if (bf16_box_map(&mw, wb, FMAX, wl.ldwb)) return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      value_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      V_SMEM);
  if (err) return err;

  pack_kernel<<<132, 256, 0, st>>>(W, (unsigned short*)wb, wl);
  err = (int)cudaGetLastError();
  if (err) return err;

  VArgs args{pts, W, B, udf, n, (sz.tiles + 1) / 2};
  value_wgmma_kernel<<<(unsigned)sz.blocks, NTW, V_SMEM, st>>>(mw, args, wl);
  return (int)cudaGetLastError();
}

}  // extern "C"
