// Fused UDF field query, value only, at the 3xTF32 tier (fp32 accuracy):
// the dense extraction grid and the threshold selector's certify probe, on
// Hopper's warpgroup tensor cores (wgmma .tf32) fed by TMA.
//
// Replaces: emap_tpu/kernels/mlp_query.py::_pallas_value at precision
// "high" and "highest" (pallas_udf_value, from the grid pass of
// emap_tpu/extract/pointcloud.py and the probe of
// emap_tpu/extract/autothresh.py; every shipped conf's model precision is
// "high"). mlp_value.cu keeps the mma.sync design of the same tier, which
// is timed beside this kernel and is on no path, and runs the bf16 tier.
//
// Computes, per point, what mlp_value.cu computes: the in-kernel PE
// encode; the hidden linears with softplus(100 z)/100 (the skip concat
// scaled by 1/sqrt2); the abs/square/sdf head, divided by scale. Out: udf
// (n,). Every hidden product is fp32-accurate 3xTF32: each operand x split
// into hi = rna(x) and lo = rna(x - hi), lo*hi and hi*lo before hi*hi into
// a fresh accumulator for each 32 contraction steps, which is then added to
// the running sum with a rounded fp32 add (kernels/mlp_query.py::
// tf32x3_matmul sums so). Softplus is the exact fp32 form (softplus100);
// the head's one-row product is fp32 FMA of fp32 operands.
//
// Bound on the H100: operations. 2 sum(in_l out_l) FLOP a point (0.92
// MFLOP at ABC width) at three TF32 passes of 495 TFLOP/s: >= 11.67 ms a
// 128^3 pass (2,097,152 points), >= 23.34 ms a 256^3 chunk, against 36
// bytes of input and output a point. What the design does:
//   * pack_tf32_kernel (mlp_tf32.cuh) writes the forward blocks of
//     mlp_query_tf32.cu's pre-split pack once a launch, without its
//     transposed ones: a (512, ldf) fp32 array (3.8 MB at ABC width,
//     L2-resident);
//   * a persistent grid, one block an SM, each block a producer
//     warpgroup and two consumer warpgroups walking 64-point tiles through
//     every layer together. The activations stay fp32 in one 64-point x
//     256-feature tile of shared memory (point-major, K-major for A,
//     swizzled as tile_at), which each layer's outputs overwrite;
//   * each layer's outputs go in passes of 64 (m64n64k8, A split in
//     registers from the tile, B from the ring), the consumers taking
//     alternate passes, each pass's exact softplus epilogue right after
//     its products. A consumer's activated passes wait in registers until
//     both consumers have read the whole tile (a named barrier), then go
//     over it, and a second barrier hands the tile to the next layer.
//     Deferring the stores so costs no time: it is faster than a second
//     tile that takes each pass's outputs at once
//     (scripts/torch_kernel_ablation.py value_tf32_two_tiles);
//   * ptxas gives each thread the launch bound's 168 registers (setmaxnreg
//     moves registers between warpgroups at run time, not in the
//     compiler): a pass's 32 accumulators, its chunk's 32, two sets of
//     split A fragments (32 each), so the next chunk's A is loaded and
//     split while the current chunk's wgmmas run, and the first pass's 32
//     held outputs;
//   * each consumer has its own 3-stage mbarrier ring of 16 KB entries (64
//     output rows x 32 contraction steps, hi and lo), fed by a producer
//     warp of its own with TMA loads of its passes' weights in its order;
//   * the last hidden layer's activations never reach the tile: each
//     consumer adds its passes' share of the head's dot in registers, the
//     four threads holding a point's features add theirs by quad shuffles,
//     and the two consumers' sums meet in 512 bytes of shared memory.
// 165,472 bytes of shared memory: the 64 KB tile, 2 x 3 x 16 KB ring
// entries, the head's sums, the mbarriers and 1 KB of alignment.
// Launches: pack_tf32_kernel, value_tf32_kernel.

#include "mlp_tf32.cuh"

using namespace emap;

namespace {

constexpr int V_NP = 1;  // 64-row ring entries a pass: passes of 64 outputs
constexpr int V_STAGES = 3;         // ring stages a consumer
constexpr int V_CONSUMERS = 2;
// passes of a FMAX-wide product a consumer takes, held until stored
constexpr int V_HELD = FMAX / (64 * V_NP) / V_CONSUMERS;
constexpr int V_ENTRY_BYTES = 2 * T_BOX_BYTES;  // 64 rows, hi and lo
constexpr int V_SMEM = V_CONSUMERS * V_STAGES * V_ENTRY_BYTES +
                       T_TILE_BYTES + V_CONSUMERS * PW * 4 +
                       2 * V_CONSUMERS * V_STAGES * 8 + 1024;

// The passes of a product of N outputs (64 V_NP outputs each), and the
// 64-row ring entries of pass k: rows past the outputs are zero weights.
__host__ __device__ inline int passes(int N) {
  return (N + 64 * V_NP - 1) / (64 * V_NP);
}
__host__ __device__ inline int pass_entries(int N, int k) {
  const int rest = (N - 64 * V_NP * k + 63) / 64;
  return rest < V_NP ? rest : V_NP;
}

// parse_tf32, and a head whose input is the last hidden layer's output
// alone (no skip at the head). 0 on success.
int parse_value(const int* h, float scale, TLayout* tl) {
  if (parse_tf32(h, scale, tl) || tl->lay.skip[tl->lay.L - 1]) return 1;
  *tl = forward_only(*tl);
  return 0;
}

struct VArgs {
  const float* pts;  // (8, n) raw points
  const float* W;    // (rmax, ldw) fp32 pack: the head's row
  const float* B;    // (rmax, L)
  float* udf;        // (n,)
  long long n, tiles;
};

// Consumer w's producer: the ring entries of its passes (w, w +
// V_CONSUMERS, ...), in its order: per tile of the block (first, first +
// step, ...) the layers 0 .. L-2, per layer the passes, per pass the
// contraction chunks, per chunk the pass's entries.
__device__ void produce_value(const CUtensorMap* mp, const TLayout& tl,
                              long long tiles, long long first,
                              long long step, int w, unsigned char* ring,
                              uint64_t* full, uint64_t* empty) {
  const int L = tl.lay.L;
  int i = 0;
  for (long long tt = first; tt < tiles; tt += step)
    for (int l = 0; l < L - 1; ++l) {
      const int N = tl.lay.out[l], K = tl.kf[l];
      for (int k = w; k < passes(N); k += V_CONSUMERS)
        for (int c = 0; c < K / 32; ++c)
          for (int e = 0; e < pass_entries(N, k); ++e, ++i) {
            const int stage = i % V_STAGES;
            mbar_wait(&empty[stage], ((i / V_STAGES) & 1) ^ 1);
            mbar_expect_tx(&full[stage], V_ENTRY_BYTES);
            tma_entry(ring + stage * V_ENTRY_BYTES, mp, tl.offf[l] + 32 * c,
                      64 * (V_NP * k + e), 1, T_BOX_BYTES, &full[stage]);
          }
    }
}

__global__ void __launch_bounds__(NTW, 1)
    value_tf32_kernel(const __grid_constant__ CUtensorMap mp, VArgs a,
                      TLayout tl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* rings = smem;  // V_CONSUMERS x V_STAGES entries
  unsigned char* tile = rings + V_CONSUMERS * V_STAGES * V_ENTRY_BYTES;
  float* red = reinterpret_cast<float*>(tile + T_TILE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(red + V_CONSUMERS * PW);
  uint64_t* empty = full + V_CONSUMERS * V_STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < V_CONSUMERS * V_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a warp of its consumer
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x < WG) {
    regs_dec<40>();
    const int w = threadIdx.x / 32;  // warp w feeds consumer w
    if (w < V_CONSUMERS && threadIdx.x % 32 == 0)
      produce_value(&mp, tl, a.tiles, blockIdx.x, gridDim.x, w,
                    rings + w * V_STAGES * V_ENTRY_BYTES,
                    full + w * V_STAGES, empty + w * V_STAGES);
    return;
  }
  regs_inc<232>();

  // the consumer, broadcast from lane 0 so that the compiler sees it
  // warp-uniform (a wgmma in a branch it takes for divergent is serialized)
  const int cw = __shfl_sync(0xffffffffu, (int)threadIdx.x / WG - 1, 0);
  const int t = threadIdx.x % WG;
  // this thread's points p, p + 8 of the tile and its features 8 j + 2 q +
  // {0, 1} of each 8-feature group (the accumulator's and A's layout)
  const int p = 16 * (t >> 5) + ((t & 31) >> 2), q = t & 3;
  const uint32_t ring = smem_u32(rings + cw * V_STAGES * V_ENTRY_BYTES);
  uint64_t* const cfull = full + cw * V_STAGES;
  uint64_t* const cempty = empty + cw * V_STAGES;
  const Layout& lay = tl.lay;
  const int L = lay.L;
  const size_t ld = (size_t)a.n;
  const float* whead = a.W + lay.off[L - 1];  // the head's one row
  long long p0 = 0;  // the tile's first point
  int i = 0;         // ring entries consumed
  float acc[V_NP][32], part[V_NP][32];

  auto csync = [] { named_sync(1, V_CONSUMERS * WG); };
  // features [from, to) of this thread's points in `tile`: x (x scale), 0
  // past d0p; this consumer's 8-feature groups (every V_CONSUMERS-th)
  auto fill_x = [&](unsigned char* tile, int from, int to, float scale) {
    for (int g = from >> 3; g < (to + 7) >> 3; ++g) {
      if (g % V_CONSUMERS != cw) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = 8 * g + 2 * q + (e & 1), pt = p + 8 * (e >> 1);
        if (f >= from && f < to) {
          const int r = f - from;
          *tile_ptr(tile, pt, f) =
              (r < lay.d0p ? encode_row(a.pts, ld, (size_t)(p0 + pt), r, lay)
                           : 0.f) *
              scale;
        }
      }
    }
  };
  // one chunk of a pass: wait for its ne ring entries, then its 4 k8 steps
  // x 3 passes on A (ah, al) into part; while they run, chunk `next`'s A
  // fragments (when next < nc) are loaded and split into (nh, nl); then
  // part into acc with a rounded fp32 add
  auto chunk = [&](unsigned char* in, int ne, unsigned (&ah)[4][4],
                   unsigned (&al)[4][4], int next, int nc,
                   unsigned (&nh)[4][4], unsigned (&nl)[4][4]) {
    for (int e = 0; e < ne; ++e)
      mbar_wait(&cfull[(i + e) % V_STAGES], ((i + e) / V_STAGES) & 1);
    // the split fragments computed before the fence, not sunk past it
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      pin(ah[s]);
      pin(al[s]);
    }
    wg_fence();
#pragma unroll
    for (int e = 0; e < V_NP; ++e) {
      if (V_NP == 1 || e < ne) {
        const uint32_t bh = ring + ((i + e) % V_STAGES) * V_ENTRY_BYTES,
                       bl = bh + T_BOX_BYTES;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          wgmma_tf32_n64(part[e], al[s], desc_kmajor(bh, s), s);
          wgmma_tf32_n64(part[e], ah[s], desc_kmajor(bl, s), 1);
          wgmma_tf32_n64(part[e], ah[s], desc_kmajor(bh, s), 1);
        }
      }
    }
    wg_commit();
    if (next < nc) {
      split_a_chunk(in, p, q, next, nh, nl);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        pin(nh[s]);
        pin(nl[s]);
      }
    }
    wg_wait0();
    if ((t & 31) == 0)
      for (int e = 0; e < ne; ++e) mbar_arrive(&cempty[(i + e) % V_STAGES]);
#pragma unroll
    for (int e = 0; e < V_NP; ++e)
      if (V_NP == 1 || e < ne)
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[e][r] += part[e][r];
    i += ne;
  };
  // acc = one pass (ne entries) of a product over K contraction steps: A
  // the input tile's first K features, B the ring's next entries
  auto product = [&](unsigned char* in, int K, int ne) {
#pragma unroll
    for (int e = 0; e < V_NP; ++e)
#pragma unroll
      for (int r = 0; r < 32; ++r) acc[e][r] = 0.f;
    const int nc = K / 32;
    unsigned xh[4][4], xl[4][4], yh[4][4], yl[4][4];
    split_a_chunk(in, p, q, 0, xh, xl);
    for (int c = 0; c < nc; c += 2) {
      chunk(in, ne, xh, xl, c + 1, nc, yh, yl);
      if (c + 1 < nc) chunk(in, ne, yh, yl, c + 2, nc, xh, xl);
    }
  };
  // the epilogue of pass k of layer l in place: acc = softplus(100 z)/100
  // x scale on the M live outputs, 0 past them. Accumulator element 4 j +
  // e of entry n holds point p + 8 (e >> 1), output 64 (V_NP k + n) + 8 j +
  // 2 q + (e & 1)
  auto activate = [&](int l, int k, int M, float scale) {
#pragma unroll
    for (int n = 0; n < V_NP; ++n)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 64 * (V_NP * k + n) + 8 * j + 2 * q + (e & 1);
          const float bias = f < M ? a.B[f * L + l] : 0.f;
          const float v = softplus100(acc[n][4 * j + e] + bias) * scale;
          acc[n][4 * j + e] = f < M ? v : 0.f;
        }
  };

  for (long long tt = blockIdx.x; tt < a.tiles; tt += gridDim.x) {
    p0 = tt * PW;
    // x = PE(points): layer 0's input, zeros up to its contraction
    fill_x(tile, 0, tl.kf[0], 1.f);
    csync();
    for (int l = 0; l < L - 1; ++l) {
      const int M = lay.out[l], K = tl.kf[l], np = passes(M);
      const bool head = l == L - 2;
      const float scale = lay.skip[l + 1] ? INV_SQRT2 : 1.f;
      float s[2] = {0.f, 0.f};  // the head's dot: this thread's share
      // this consumer's passes (cw, cw + V_CONSUMERS), activated, wait in
      // registers until both consumers have read the whole tile
      float held[V_HELD][V_NP][32];
#pragma unroll
      for (int kk = 0; kk < V_HELD; ++kk) {
        const int k = cw + V_CONSUMERS * kk;
        if (k < np) {
          product(tile, K, pass_entries(M, k));
          activate(l, k, M, scale);
#pragma unroll
          for (int n = 0; n < V_NP; ++n)
#pragma unroll
            for (int r = 0; r < 32; ++r) held[kk][n][r] = acc[n][r];
        }
      }
      if (!head) csync();
#pragma unroll
      for (int kk = 0; kk < V_HELD; ++kk) {
        const int k = cw + V_CONSUMERS * kk;
        if (k >= np) continue;
#pragma unroll
        for (int n = 0; n < V_NP; ++n)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int f0 = 64 * (V_NP * k + n) + 8 * j + 2 * q;
            const float* v = held[kk][n] + 4 * j;
            if (head) {
              // the last hidden layer's outputs: their share of w . u
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (f0 + (e & 1) < M)
                  s[e >> 1] = fmaf(whead[f0 + (e & 1)], v[e], s[e >> 1]);
            } else {
              *reinterpret_cast<float2*>(tile_ptr(tile, p, f0)) =
                  make_float2(v[0], v[1]);
              *reinterpret_cast<float2*>(tile_ptr(tile, p + 8, f0)) =
                  make_float2(v[2], v[3]);
            }
          }
      }
      if (head) {
        // the quad's shares, then the consumer's sum for points p, p + 8
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
          s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
          if (q == 0) red[cw * PW + p + 8 * h] = s[h];
        }
      } else if (lay.skip[l + 1]) {
        // at a skip the features from out_l on are x / sqrt2, once every
        // pass has written its outputs
        csync();
        fill_x(tile, M, tl.kf[l + 1], INV_SQRT2);
      }
      csync();
    }
    // the head: y0 = w . u_{L-1} + b; udf = |y0|, y0^2 or y0, / scale
    if (cw == 0 && q == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pt = p + 8 * h;
        const float y0 = (red[pt] + red[PW + pt]) + a.B[L - 1];
        const float u = lay.udf_type == 0   ? fabsf(y0)
                        : lay.udf_type == 1 ? y0 * y0
                                            : y0;
        a.udf[p0 + pt] = u / lay.scale;
      }
    }
  }
}

// Scratch and launch shape, by kernels/mlp_query.py::value_tf32_plan.
struct Sizes {
  long long pack, smem, blocks, tiles;
};

int sizes_of(const TLayout& tl, long long n, Sizes* s) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) ||
      sms <= 0)
    return 1;
  s->tiles = (n + PW - 1) / PW;
  s->blocks = s->tiles < sms ? s->tiles : sms;
  s->pack = (long long)2 * FMAX * tl.ldp;
  s->smem = V_SMEM;
  return 0;
}

}  // namespace

extern "C" {

// The scratch and launch shape at n points on the current device: out[0]
// pack floats, [1] the value kernel's dynamic shared bytes, [2] its
// blocks, [3] its 64-point tiles. 0 on success, 1 on a layout the kernels
// do not take.
int emap_mlp_value_tf32_sizes(const int* layout, long long n,
                              long long* out) {
  TLayout tl;
  Sizes s;
  if (parse_value(layout, 1.f, &tl) || n <= 0 || sizes_of(tl, n, &s))
    return 1;
  const long long v[4] = {s.pack, s.smem, s.blocks, s.tiles};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,); fp32, contiguous, on
// the device; n a multiple of 64; tier TF32X3. pack: the forward-only pack,
// as emap_mlp_value_tf32_sizes sizes it. Returns cudaErrorInvalidValue on
// anything else or a tensor map cuTensorMapEncodeTiled refuses, else the
// first nonzero CUDA error (the shared-memory opt-in, each launch).
int emap_mlp_value_tf32(const float* pts, const float* W, const float* B,
                        float* udf, float* pack, long long n,
                        const int* layout, float scale, int tier,
                        void* stream) {
  TLayout tl;
  Sizes sz;
  if (parse_value(layout, scale, &tl) || n <= 0 || n % PW ||
      tier != TF32X3 || sizes_of(tl, n, &sz))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap mp;
  if (f32_box_map(&mp, pack, 2 * FMAX, tl.ldp))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      value_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      V_SMEM);
  if (err) return err;

  pack_tf32_kernel<<<132, 256, 0, st>>>(W, pack, tl);
  err = (int)cudaGetLastError();
  if (err) return err;

  VArgs args{pts, W, B, udf, n, sz.tiles};
  value_tf32_kernel<<<(unsigned)sz.blocks, NTW, V_SMEM, st>>>(mp, args, tl);
  return (int)cudaGetLastError();
}

}  // extern "C"
