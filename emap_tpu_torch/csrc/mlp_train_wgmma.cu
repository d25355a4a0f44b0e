// Second-order backward of the fused training field query at the bf16 tier,
// on Hopper's warpgroup tensor cores (wgmma) fed by TMA.
//
// Replaces: emap_tpu/kernels/mlp_train.py::_pallas_train_bwd with
// fuse_pe=True (per-tile math in _train_bwd_math) at the (bf16, bf16) pair
// of tiers, the pair every shipped conf trains at (field_precision
// "default", no bwd_precision); mlp_train_tf32.cu runs the pairs with a
// 3xTF32 tier. Given the cotangents ubar (on udf) and gbar (on the spatial
// gradient) it recomputes the forward from the raw points, reruns the
// spatial-gradient chain, runs the ascend/descend adjoint chains
// (kernels/mlp_train.py, module docstring) and sums the packed weight and
// bias gradients over all points. Every product takes bf16 operands
// (rounded to nearest even, as tier_dot's .to(bfloat16)) with fp32 sums.
//
// Bound on the H100: operations. 12 sum(in_l out_l) - 4 in_0 out_0 FLOP a
// point (kernels/mlp_train.py::train_bwd_flops) at 989 TFLOP/s of dense
// bf16: >= 0.64 ms at the step's 116,736 points at ABC width, against 68
// bytes of input a point and 2.2 MB of output. What the design does about
// what holds it above that (PERF.md §6):
//   * the weights are rounded to bf16 once a launch (pack_kernel) into
//     64-column aligned blocks, and one producer warp keeps TMA loads of
//     64 x 128 weight chunks in flight through a 4-stage mbarrier ring;
//     the consumer warpgroups do no copy work;
//   * the 30 chain products run as wgmma m64n128k16 with both operands in
//     shared memory: each of two consumer warpgroups owns 64 points (the
//     M side), so every weight chunk serves 128 points; the activations sit
//     feature-major (a 128-byte row of 64 points a feature) and are read
//     MN-major (the transpose bit), the forward and ascend products read W
//     K-major and the gradient and descend products read the same chunk
//     shape of W MN-major, so one copy of W serves both directions;
//   * the accumulators and the epilogues (softplus, sigmoid, carry, the
//     skip's 1/sqrt2) stay in registers; each product's result is written
//     once as bf16 into the tile the next product reads, and the same tile
//     goes to device memory by TMA as the weight-gradient factor (U, Q-hat,
//     R, Z-hat: bf16, the tier's own rounding, feature-major, points
//     contiguous), so the contraction reads half the bytes it read in fp32;
//   * the bias gradient sums z-hat in fp32 before that rounding, a partial
//     a block summed in a fixed order;
//   * the weight gradient W-bar_l = R_l Q-hat_l^T + Z-hat_l U_l^T is a TMA
//     plus wgmma GEMM over KS fixed point ranges (wbar_kernel), reduced in
//     a fixed order (reduce_kernel): no atomics, bit-identical launches
//     (both in mlp_train_gemm.cuh, shared with mlp_train_tf32.cu's mixed
//     pair).
// Sums: every 64-deep chunk of a contraction goes into a fresh accumulator
// that is then added to the running fp32 sum (the tensor cores add
// truncating: mlp_mma.cuh), in the chains and in the GEMM alike.
// Device scratch: the factors, sum over layers of 2 (roundup(in_l, 64) +
// roundup(out_l, 64)) bf16 rows a point, and the side arrays that do not
// fit beside the tile, sigmoid(100 z_l) and carry_{l+1}, then s-hat_l, of
// each hidden layer: 2 x 256 fp32 a layer a point, written and read back
// as float4s by the thread that owns them, brought into L2 by one bulk
// prefetch as the product whose epilogue reads them starts. They stay
// fp32: a narrower width moves W-bar off its plain version by as much as
// the kernel's own rounding (scripts/torch_side_precision.py).
// Launches: pack_kernel, per_point_kernel, wbar_kernel, reduce_kernel.

#include "mlp_train_gemm.cuh"

using namespace emap;

namespace {

constexpr int PP_SMEM = STAGES * STAGE_BYTES + 4 * TILE_BYTES +
                        (2 * 4 * FMAX + 2 * 3 * PW + 2 * 2 * PW) * 4 +
                        2 * STAGES * 8 + 1024;

// ---- per point ------------------------------------------------------------

struct PPArgs {
  const float* pts;   // (8, n) raw points
  const float* W;     // (rmax, ldw) fp32 pack: the head's row
  const float* B;     // (rmax, L)
  const float* ubar;  // (n,)
  const float* gbar;  // (8, n)
  float* side;        // side arrays
  float* bpart;       // (blocks, rmax, L) bias partials
  unsigned short* F;  // (frows, n) factors
  long long n;
};

__global__ void __launch_bounds__(NTW, 1)
    per_point_kernel(const __grid_constant__ CUtensorMap mw,
                     const __grid_constant__ CUtensorMap mf, PPArgs a,
                     WLayout wl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* tiles = ring + STAGES * STAGE_BYTES;
  float* bsum = reinterpret_cast<float*>(tiles + 4 * TILE_BYTES);
  float* vec = bsum + 2 * 4 * FMAX;  // [wg][dy, z-hat_{L-1}, r-hat_{L-1}][p]
  float* red = vec + 2 * 3 * PW;     // [wg][2][p] head partial sums
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * 2 * PW);
  uint64_t* empty = full + STAGES;

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
    if (threadIdx.x == 0) produce_chunks<2, 1>(&mw, wl, ring, full, empty);
    return;
  }
  regs_inc<232>();

  const Layout& lay = wl.lay;
  const int L = lay.L, rmax = lay.rmax;
  const int wg = threadIdx.x / WG - 1;  // consumer 0 or 1
  const int t = threadIdx.x % WG, w = t >> 5, q = t & 31;
  const int tile_id = blockIdx.x * 2 + wg;
  const long long p0 = (long long)tile_id * PW;
  const bool valid = p0 < a.n;  // a ragged N leaves the last one empty
  const size_t ld = (size_t)a.n;
  unsigned char* cur = tiles + (2 * wg) * TILE_BYTES;
  unsigned char* nxt = cur + TILE_BYTES;
  float* dyv = vec + wg * 3 * PW;
  float* zhv = dyv + PW;
  float* rhv = zhv + PW;
  const uint32_t ring_addr = smem_u32(ring);
  const float* whead = a.W + lay.off[L - 1];  // the head's one row
  int stage = 0;
  unsigned phase = 0;
  float acc[64], part[64];

  auto wg_sync = [&] { named_sync(1 + wg, WG); };
  auto side = [&](int l, int kind, int h, int j) {
    return side_slot(
        a.side + ((((size_t)tile_id * (L - 1) + l) * 2 + kind) * SIDE), h, j,
        t);
  };
  // the accumulator element (j, e) of half h: point and feature
  auto pt = [&](int e) { return acc_point(t, e); };
  auto ft = [&](int h, int j, int e) { return acc_feature(t, h, j, e); };
  // nxt may be written once the store that last read it has read it
  auto claim = [&] {
    if (t == 0) bulk_wait_read();
    wg_sync();
  };
  // the side arrays kind (0 sigmoid, 1 carry / s-hat) of layer l, both
  // halves, on their way to L2 while the product whose epilogue reads them
  // runs (one product ahead measured slower: L2 thrashed)
  auto prefetch = [&](int l, int kind) {
    if (t == 0)
      l2_prefetch(a.side + (((size_t)tile_id * (L - 1) + l) * 2 + kind) * SIDE,
                  SIDE * 4);
  };
  // nxt's writes visible to wgmma and TMA; rows [0, rows) of it stored as
  // factor rows [row, row + rows) of the tile's points; nxt becomes cur
  auto publish = [&](int row, int rows) {
    fence_async_smem();
    wg_sync();
    if (t == 0 && valid) {
      for (int b = 0; b < rows / 64; ++b)
        tma_store(&mf, nxt + b * BOX_BYTES, (int)p0, row + 64 * b);
      bulk_commit();
    }
    unsigned char* s = cur;
    cur = nxt;
    nxt = s;
  };
  // rows [from, to) of nxt: v(r, p) for the tile's points, 0 past n
  auto fill_rows = [&](int from, int to, auto v) {
    for (int i = t; i < (to - from) * PW; i += WG) {
      const int r = from + i / PW, p = i % PW;
      st_bf16(nxt, r, p, valid ? v(r, (size_t)(p0 + p)) : 0.f);
    }
  };
  auto x_row = [&](int r, size_t n) {
    return r < lay.d0p ? encode_row(a.pts, ld, n, r, lay) : 0.f;
  };
  auto gb_row = [&](int r, size_t n) {
    return r < lay.d0p ? pe_jacT_row(a.pts, a.gbar, ld, n, r, lay) : 0.f;
  };
  // the head's dot w . cur over in_{L-1} features at tier bf16; out[p]
  auto head_dot = [&](float* out, float bias) {
    wg_head_dot(whead, lay.in[L - 1], cur, red + wg * 2 * PW, out, bias, t,
                1 + wg);
  };
  // the head's transposed product: acc = w[f] v[p] at tier bf16
  auto head_outer = [&](int h, const float* v) {
    wg_head_outer(acc, whead, lay.in[L - 1], v, h, t);
  };
  auto halves = [](int N) { return (N + 127) / 128; };

  // ---- epilogues of half h ----
  // forward, layer l: a = softplus(100 z)/100 (x 1/sqrt2 before a skip),
  // s = sigmoid(100 z)
  auto epi_forward = [&](int l, int h) {
    const int M = lay.out[l];
    const bool skip = lay.skip[l + 1] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float sg[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = ft(h, j, e);
        float sig = 0.f, act = 0.f;
        if (f < M) {
          sig_softplus100(acc[4 * j + e] + a.B[f * L + l], sig, act);
          if (skip) act *= INV_SQRT2;
        }
        sg[e] = sig;
        if (f < M || !skip) st_bf16(nxt, f, pt(e), act);
      }
      *side(l, 0, h, j) = make_float4(sg[0], sg[1], sg[2], sg[3]);
    }
  };
  // gradient chain, layer l: carry = the non-x rows of q (scaled at a
  // skip), r_{l-1} = carry * s_{l-1}
  auto epi_grad = [&](int l, int h) {
    const int c = lay.out[l - 1];
    const bool skip = lay.skip[l] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 sv = *side(l - 1, 0, h, j);
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      float ch[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = ft(h, j, e);
        const float qv = acc[4 * j + e];
        const float carry = skip ? qv * INV_SQRT2 : qv;
        ch[e] = f < c ? carry : 0.f;
        st_bf16(nxt, f, pt(e), f < c ? carry * sg[e] : 0.f);
      }
      *side(l - 1, 1, h, j) = make_float4(ch[0], ch[1], ch[2], ch[3]);
    }
  };
  // ascend, layer l: s-hat_l = r-hat * carry_{l+1} (over the carry);
  // q-hat_{l+1} = r-hat * s_l (x 1/sqrt2 before a skip)
  auto epi_ascend = [&](int l, int h) {
    const int M = lay.out[l];
    const bool skip = lay.skip[l + 1] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float4* cp = side(l, 1, h, j);
      const float4 cv = *cp, sv = *side(l, 0, h, j);
      const float carry[4] = {cv.x, cv.y, cv.z, cv.w};
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      float sh[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = ft(h, j, e);
        const float r = acc[4 * j + e];
        sh[e] = f < M ? r * carry[e] : 0.f;
        const float ch = r * sg[e];
        const float qv = skip ? ch * INV_SQRT2 : ch;
        if (f < M || !skip) st_bf16(nxt, f, pt(e), f < M ? qv : 0.f);
      }
      *cp = make_float4(sh[0], sh[1], sh[2], sh[3]);
    }
  };
  // descend, layer l: a-hat = the non-x rows of u-hat (scaled at a skip),
  // z-hat_{l-1} = a-hat * s + s-hat * (100 s (1 - s)); the bias sums of
  // the warp's 16 points into bsum
  auto epi_descend = [&](int l, int h) {
    const int c = lay.out[l - 1];
    const bool skip = lay.skip[l] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 sv = *side(l - 1, 0, h, j), hv = *side(l - 1, 1, h, j);
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      const float sh[4] = {hv.x, hv.y, hv.z, hv.w};
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = ft(h, j, e);
        const float uh = acc[4 * j + e];
        const float av = skip ? uh * INV_SQRT2 : uh;
        z[e] = f < c ? av * sg[e] + sh[e] * ((100.f * sg[e]) * (1.f - sg[e]))
                     : 0.f;
        st_bf16(nxt, f, pt(e), z[e]);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = valid ? z[e] + z[e + 2] : 0.f;
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (q < 4) bsum[(wg * 4 + w) * FMAX + ft(h, j, e)] = v;
      }
    }
  };
  // b-bar_lb of the block's 128 points: the 8 warps' sums in a fixed order
  auto bias_flush = [&](int lb) {
    named_sync(3, 2 * WG);
    const int o = wg * WG + t;
    if (o < rmax) {
      float v = 0.f;
      if (o < lay.out[lb])
        for (int k = 0; k < 8; ++k) v += bsum[k * FMAX + o];
      a.bpart[(size_t)blockIdx.x * rmax * L + (size_t)o * L + lb] = v;
    }
    named_sync(3, 2 * WG);
  };

  // x = PE(points): layer 0's input, U_0
  claim();
  fill_rows(0, wl.kpad[0], x_row);
  publish(wl.rowU[0], wl.kpad[0]);

  // forward recompute; U_{l+1}; s_l to the side arrays
  for (int l = 0; l < L - 1; ++l) {
    int N, K;
    prod_shape(wl, l, false, N, K);
    claim();
    for (int h = 0; h < halves(N); ++h) {
      product_half<0>(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                      full, empty);
      epi_forward(l, h);
    }
    if (lay.skip[l + 1])
      fill_rows(lay.out[l], wl.kpad[l + 1], [&](int r, size_t n) {
        return x_row(r - lay.out[l], n) * INV_SQRT2;
      });
    publish(wl.rowU[l + 1], wl.kpad[l + 1]);
  }
  // the head: y0 = w . u_{L-1} + b, dy = d udf / d y0; R_{L-1} = dy
  head_dot(dyv, a.B[L - 1]);
  if (t < PW) {
    const float y0 = dyv[t];
    float dy;
    if (lay.udf_type == 0) dy = sign_of(y0) / lay.scale;
    else if (lay.udf_type == 1) dy = 2.f * y0 / lay.scale;
    else dy = 1.f / lay.scale;
    dyv[t] = dy;
    if (valid) a.F[(size_t)wl.rowR[L - 1] * ld + p0 + t] = bf16_bits(dy);
  }
  wg_sync();

  // spatial-gradient chain: q = W_l^T r_l; R_{l-1}
  claim();
  for (int h = 0; h < halves(lay.in[L - 1]); ++h) {
    head_outer(h, dyv);
    epi_grad(L - 1, h);
  }
  publish(wl.rowR[L - 2], wl.opad[L - 2]);
  for (int l = L - 2; l >= 1; --l) {
    int N, K;
    prod_shape(wl, l, true, N, K);
    claim();
    prefetch(l - 1, 0);
    for (int h = 0; h < halves(N); ++h) {
      product_half<1>(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                      full, empty);
      epi_grad(l, h);
    }
    publish(wl.rowR[l - 1], wl.opad[l - 1]);
  }

  // ascend: q-hat_0 = (dPE/dx)^T gbar, then r-hat = W_l q-hat_l; Q-hat_l
  claim();
  fill_rows(0, wl.kpad[0], gb_row);
  publish(wl.rowQ[0], wl.kpad[0]);
  for (int l = 0; l < L - 1; ++l) {
    int N, K;
    prod_shape(wl, l, false, N, K);
    claim();
    prefetch(l, 0);
    prefetch(l, 1);
    for (int h = 0; h < halves(N); ++h) {
      product_half<0>(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                      full, empty);
      epi_ascend(l, h);
    }
    if (lay.skip[l + 1])
      fill_rows(lay.out[l], wl.kpad[l + 1], [&](int r, size_t n) {
        return gb_row(r - lay.out[l], n) * INV_SQRT2;
      });
    publish(wl.rowQ[l + 1], wl.kpad[l + 1]);
  }
  head_dot(rhv, 0.f);

  // descend: z-hat_{L-1} = ubar * dy (+ r-hat * 2/scale, square head), then
  // u-hat = W_l^T z-hat_l; Z-hat_l; the bias partials
  if (t < PW) {
    float z = 0.f;
    if (valid) {
      z = a.ubar[p0 + t] * dyv[t];
      if (lay.udf_type == 1) z = z + rhv[t] * (2.f / lay.scale);
      a.F[(size_t)wl.rowZ[L - 1] * ld + p0 + t] = bf16_bits(z);
    }
    zhv[t] = z;
  }
  wg_sync();
  claim();
  for (int h = 0; h < halves(lay.in[L - 1]); ++h) {
    head_outer(h, zhv);
    epi_descend(L - 1, h);
  }
  publish(wl.rowZ[L - 2], wl.opad[L - 2]);
  bias_flush(L - 2);
  for (int l = L - 2; l >= 1; --l) {
    int N, K;
    prod_shape(wl, l, true, N, K);
    claim();
    prefetch(l - 1, 0);
    prefetch(l - 1, 1);
    for (int h = 0; h < halves(N); ++h) {
      product_half<1>(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                      full, empty);
      epi_descend(l, h);
    }
    publish(wl.rowZ[l - 1], wl.opad[l - 1]);
    bias_flush(l - 1);
  }
  // b-bar of the head: the block's z-hat_{L-1}, its points in order
  named_sync(3, 2 * WG);
  const int o = wg * WG + t;
  if (o < rmax) {
    float v = 0.f;
    if (o == 0)  // consumer 0's z-hat_{L-1}, then consumer 1's (0 if empty)
      for (int k = 0; k < 2; ++k)
        for (int p = 0; p < PW; ++p) v += vec[(3 * k + 1) * PW + p];
    a.bpart[(size_t)blockIdx.x * rmax * L + (size_t)o * L + L - 1] = v;
  }
  if (t == 0) bulk_wait();
}

// Scratch the wrapper allocates, by kernels/mlp_train.py::wgmma_plan.
struct Sizes {
  long long wb, frows, side, partials, pp_smem, g_smem, blocks;
};

Sizes sizes_of(const WLayout& wl, long long n) {
  const Layout& lay = wl.lay;
  Sizes s;
  s.blocks = (n + PB - 1) / PB;
  s.wb = (long long)FMAX * wl.ldwb;
  s.frows = wl.frows;
  s.side = 2 * s.blocks * (lay.L - 1) * 2LL * SIDE;
  s.partials = (long long)KS * lay.rmax * lay.ldw +
               s.blocks * lay.rmax * lay.L;
  s.pp_smem = PP_SMEM;
  s.g_smem = G_SMEM;
  return s;
}

}  // namespace

extern "C" {

// The scratch and shared memory of a launch at n points: out[0] bf16
// weight-pack elements, [1] factor rows (x n bf16), [2] side-array floats,
// [3] partial floats, [4] and [5] the per-point and GEMM kernels' dynamic
// shared bytes, [6] per-point blocks. 0 on success, 1 on a layout the
// kernels do not take.
int emap_mlp_train_wgmma_sizes(const int* layout, long long n,
                               long long* out) {
  WLayout wl;
  if (parse_wgmma(layout, 1.f, &wl) || n <= 0) return 1;
  const Sizes s = sizes_of(wl, n);
  const long long v[7] = {s.wb, s.frows, s.side, s.partials, s.pp_smem,
                          s.g_smem, s.blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// pts (8, n), W (rmax, ldw), B (rmax, L), ubar (n,), gbar (8, n) -> wbar
// (rmax, ldw), bbar (rmax, L); fp32, contiguous, on the device; n a
// multiple of 64; tier and adjoint_tier both BF16. Scratch as
// emap_mlp_train_wgmma_sizes gives it: wb (bf16), factors (bf16), side and
// partials (fp32). Returns cudaErrorInvalidValue on anything else or a
// tensor map cuTensorMapEncodeTiled refuses, else the first nonzero CUDA error (the
// shared-memory opt-ins, each launch).
int emap_mlp_train_wgmma(const float* pts, const float* W, const float* B,
                         const float* ubar, const float* gbar, float* wbar,
                         float* bbar, void* wb, void* factors, float* side,
                         float* partials, long long n, const int* layout,
                         float scale, int tier, int adjoint_tier,
                         void* stream) {
  WLayout wl;
  if (parse_wgmma(layout, scale, &wl) || n <= 0 || n % PW ||
      tier != BF16 || adjoint_tier != BF16)
    return (int)cudaErrorInvalidValue;
  const Layout& lay = wl.lay;
  const cudaStream_t st = (cudaStream_t)stream;
  const Sizes sz = sizes_of(wl, n);
  CUtensorMap mw, mf;
  if (bf16_box_map(&mw, wb, FMAX, wl.ldwb) ||
      bf16_box_map(&mf, factors, wl.frows, n))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaFuncSetAttribute(
      per_point_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PP_SMEM);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        wbar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
  if (err) return err;

  pack_kernel<<<132, 256, 0, st>>>(W, (unsigned short*)wb, wl);
  err = (int)cudaGetLastError();
  if (err) return err;

  float* wpart = partials;
  float* bpart = partials + (size_t)KS * lay.rmax * lay.ldw;
  PPArgs args{pts, W, B, ubar, gbar, side, bpart, (unsigned short*)factors, n};
  per_point_kernel<<<(unsigned)sz.blocks, NTW, PP_SMEM, st>>>(mw, mf, args,
                                                              wl);
  err = (int)cudaGetLastError();
  if (err) return err;

  const GTiles tiles = gemm_tiles(lay);
  const long long chunk = gemm_chunk(n);
  wbar_kernel<<<dim3(tiles.count, KS), NTW, G_SMEM, st>>>(mf, wl, tiles, n,
                                                          chunk, wpart);
  err = (int)cudaGetLastError();
  if (err) return err;

  const int wblocks = 264;
  reduce_kernel<<<wblocks + 64, 256, 0, st>>>(wpart, bpart, wbar, bbar, wl,
                                              (int)sz.blocks, wblocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
