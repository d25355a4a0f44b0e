// Value and spatial gradient of the fused field query at the bf16 tier, on
// Hopper's warpgroup tensor cores (wgmma) fed by TMA.
//
// Replaces: emap_tpu/kernels/mlp_query.py::_pallas_value_and_grad at
// precision "default", in every use at that tier: with f32_residuals=True
// the forward of the training query
// (emap_tpu/kernels/mlp_train.py::_train_query) and the validation chunks;
// with f32_residuals=False the extraction's sweeps at a "default" model
// precision (kernels/mlp_query.py::value_and_grad_sliced, the counterpart
// of pallas_udf_value_and_grad). mlp_query_tf32.cu takes the 3xTF32 tier;
// mlp_query.cu's bf16 instantiation is timed beside this kernel.
//
// Computes, per point, from the raw points and the fp32 pack (W, B): the
// blocked PE encode; the hidden linears with softplus(100 z)/100 (the skip
// concat scaled by 1/sqrt2) and the head's row with the abs/square/sdf
// head; the reverse pass q = W_l^T g through every layer down to lin0,
// times sigmoid(100 z) below each, the x rows of the skip layer and all of
// lin0's rows summed into d udf / d x-tilde; the PE Jacobian. Out: udf
// (n,), grad (8, n) with rows 0-2 live. Every product takes bf16 operands
// (rounded to nearest even, as tier_dot's .to(bfloat16)) with fp32 sums;
// each 64-deep chunk goes into a fresh accumulator that is then added to
// the running sum (the tensor cores add truncating: mlp_mma.cuh). Bias,
// softplus, sigmoid, the PE and its Jacobian stay fp32.
//
// Bound on the H100: operations. 4 sum(in_l out_l) FLOP a point (1.84
// MFLOP at ABC width) at 989 TFLOP/s of dense bf16: >= 0.22 ms at the
// step's 116,736 points, against 68 bytes of input and output a point.
// The design's own floor is its sigmoid side arrays (below): 1.9 GB at ABC
// width and that N, 0.57 ms at 3.35 TB/s. What the design does (the chain
// engine of mlp_wgmma.cuh, shared with mlp_train_wgmma.cu):
//   * the weights are rounded to bf16 once a launch (pack_kernel) into
//     64-column aligned blocks, and one producer warp keeps TMA loads of
//     64 x 128 weight chunks in flight through a 4-stage mbarrier ring;
//     the consumer warpgroups do no copy work;
//   * the 16 chain products at ABC width run as wgmma m64n128k16 with both
//     operands in shared memory, each of two consumer warpgroups owning 64
//     points, so every weight chunk serves 128 points: 8 forward products
//     read W K-major, 8 transposed ones read the same chunks MN-major
//     (lin0's too: its N = d0p fills part of one half);
//   * the accumulators and the epilogues stay in registers (softplus and
//     sigmoid from the special function unit's approximations, within
//     ~1e-5 of the exact fp32 values: sig_softplus100_approx); each
//     product's result is written once as bf16 into the tile the next
//     product reads; the x rows of the skip layer's transposed product
//     (x 1/sqrt2) and lin0's rows add into a d udf / d x-tilde block of
//     fp32 in shared memory, from which a last pass applies the PE
//     Jacobian;
//   * sigmoid(100 z_l) of each hidden layer does not fit beside the tiles:
//     it goes to device scratch in fp32, as the JAX training forward keeps
//     it (f32_residuals=True), or rounded to bf16 for the extraction
//     sweeps, as the JAX extraction query keeps it (f32_residuals=False:
//     query_kernel<unsigned short>), written and read back as 16- or
//     8-byte slots by the thread that owns them (the live 8-feature groups
//     only), brought into L2 by one bulk prefetch as the product whose
//     epilogue reads them starts.
// Launches: pack_kernel, query_kernel.

#include "mlp_wgmma.cuh"

using namespace emap;

namespace {

constexpr int GIN_ROWS = 64;  // rows of d udf / d x-tilde: d0p at most
constexpr int Q_SMEM = STAGES * STAGE_BYTES + 4 * TILE_BYTES +
                       (2 * GIN_ROWS * PW + 2 * 2 * PW + 2 * PW) * 4 +
                       2 * STAGES * 8 + 1024;

// parse_wgmma, and an encoded input no wider than the d udf / d x-tilde
// block. 0 on success.
int parse_query(const int* h, float scale, WLayout* wl) {
  return parse_wgmma(h, scale, wl) || wl->lay.d0p > GIN_ROWS;
}

// sigmoid(100 z) and softplus(100 z)/100 in sig_softplus100's stable form
// (mlp_mma.cuh), from the special function unit's approximations: exp as
// ex2.approx and the reciprocal as rcp.approx (each within a few fp32
// ulps; exp also carries its argument's rounding, ~1e-6 relative at
// |100 z| = 20), log1p(e) as lg2.approx(1 + e) ln 2 (2^-22 absolute) or,
// below e = 1/64, where 1 + e drops e's low bits, as its series to e^4.
// Each within ~1e-5 of the exact fp32 value, below the bf16 rounding
// (2^-9) the activation meets next, so the result sits as near the plain
// version as with the exact forms, which cost 0.7 ms of 3.2 at the step's
// N (scripts/torch_kernel_ablation.py, query_wgmma_exact_math). The
// sigmoid stays fp32 in the side arrays.
__device__ __forceinline__ void sig_softplus100_approx(float z, float& sig,
                                                       float& sp) {
  const float t = z * 100.f;
  float e, r, lg;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-fabsf(t) * 1.44269504f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(lg) : "f"(1.f + e));
  const float lp =
      e < 0.015625f
          ? e * (1.f - e * (0.5f - e * (0.33333334f - e * 0.25f)))
          : lg * 0.69314718f;
  sig = (t >= 0.f ? 1.f : e) * r;
  sp = (fmaxf(t, 0.f) + lp) * 0.01f;
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

// Element (r, p) of a consumer's d udf / d x-tilde block (GIN_ROWS x PW
// fp32), the point index XOR-swizzled by bits 1-2 of the row: the four rows
// (two apart) and eight points a warp's accumulator element reaches fall
// on 32 banks.
__device__ __forceinline__ int gin_at(int r, int p) {
  return r * PW + (p ^ (((r >> 1) & 3) << 3));
}

// S: the side arrays' element, float or unsigned short (bf16 bits).
template <typename S>
__global__ void __launch_bounds__(NTW, 1)
    query_kernel(const __grid_constant__ CUtensorMap mw, QArgs a,
                 WLayout wl) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = smem;
  unsigned char* tiles = ring + STAGES * STAGE_BYTES;
  float* gins = reinterpret_cast<float*>(tiles + 4 * TILE_BYTES);
  float* reds = gins + 2 * GIN_ROWS * PW;  // [wg][2][p] head partial sums
  float* dys = reds + 2 * 2 * PW;          // [wg][p] d udf / d y0
  uint64_t* full = reinterpret_cast<uint64_t*>(dys + 2 * PW);
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
    if (threadIdx.x == 0) produce_chunks<1, 0>(&mw, wl, ring, full, empty);
    return;
  }
  regs_inc<232>();

  const Layout& lay = wl.lay;
  const int L = lay.L;
  const int wg = threadIdx.x / WG - 1;  // consumer 0 or 1
  const int t = threadIdx.x % WG;
  const int tile_id = blockIdx.x * 2 + wg;
  const long long p0 = (long long)tile_id * PW;
  const bool valid = p0 < a.n;  // a ragged N leaves the last one empty
  const size_t ld = (size_t)a.n;
  unsigned char* cur = tiles + (2 * wg) * TILE_BYTES;
  unsigned char* nxt = cur + TILE_BYTES;
  float* gin = gins + wg * GIN_ROWS * PW;
  float* dyv = dys + wg * PW;
  const uint32_t ring_addr = smem_u32(ring);
  const float* whead = a.W + lay.off[L - 1];  // the head's one row
  int stage = 0;
  unsigned phase = 0;
  float acc[64], part[64];

  auto wg_sync = [&] { named_sync(1 + wg, WG); };
  S* const sides = static_cast<S*>(a.side) + (size_t)tile_id * (L - 1) * SIDE;
  auto side = [&](int l) { return sides + (size_t)l * SIDE; };
  auto pt = [&](int e) { return acc_point(t, e); };
  auto ft = [&](int h, int j, int e) { return acc_feature(t, h, j, e); };
  // layer l's sigmoids on their way to L2 while the product whose
  // epilogue reads them runs
  auto prefetch = [&](int l) {
    if (t == 0) l2_prefetch(side(l), SIDE * sizeof(S));
  };
  // nxt's writes visible to wgmma; nxt becomes cur
  auto publish = [&] {
    fence_async_smem();
    wg_sync();
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
  auto halves = [](int N) { return (N + 127) / 128; };

  // ---- epilogues of half h ----
  // forward, layer l: a = softplus(100 z)/100 (x 1/sqrt2 before a skip),
  // s = sigmoid(100 z) to the side array, its live 8-feature groups
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
          sig_softplus100_approx(acc[4 * j + e] + a.B[f * L + l], sig,
                                 act);
          if (skip) act *= INV_SQRT2;
        }
        sg[e] = sig;
        if (f < M || !skip) st_bf16(nxt, f, pt(e), act);
      }
      if (128 * h + 8 * j < M)
        side_put(side(l), h, j, t, make_float4(sg[0], sg[1], sg[2], sg[3]));
    }
  };
  // reverse, layer l >= 1: q = W_l^T g_l; g_{l-1} = q (x 1/sqrt2 at a
  // skip) * s_{l-1} on the c = out_{l-1} rows below the x rows, which (at
  // a skip) add to d udf / d x-tilde
  auto epi_grad = [&](int l, int h) {
    const int c = lay.out[l - 1], M = lay.in[l];
    const bool skip = lay.skip[l] != 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (128 * h + 8 * j < c) sv = side_get(side(l - 1), h, j, t);
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = ft(h, j, e);
        const float qv = acc[4 * j + e];
        const float carry = skip ? qv * INV_SQRT2 : qv;
        st_bf16(nxt, f, pt(e), f < c ? carry * sg[e] : 0.f);
        if (skip && f >= c && f < M) gin[gin_at(f - c, pt(e))] += carry;
      }
    }
  };
  // reverse, lin0: every row of q = W_0^T g_0 adds to d udf / d x-tilde
  auto epi_input = [&](int h) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = ft(h, j, e);
        if (f < lay.in[0]) gin[gin_at(f, pt(e))] += acc[4 * j + e];
      }
  };

  for (int i = t; i < GIN_ROWS * PW; i += WG) gin[i] = 0.f;
  // x = PE(points): layer 0's input
  fill_rows(0, wl.kpad[0], x_row);
  publish();

  // forward: u_{l+1} in the tile, s_l to the side arrays
  for (int l = 0; l < L - 1; ++l) {
    int N, K;
    prod_shape(wl, l, false, N, K);
    for (int h = 0; h < halves(N); ++h) {
      product_half<0>(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                      full, empty);
      epi_forward(l, h);
    }
    if (lay.skip[l + 1])
      fill_rows(lay.out[l], wl.kpad[l + 1], [&](int r, size_t n) {
        return x_row(r - lay.out[l], n) * INV_SQRT2;
      });
    publish();
  }
  // the head: y0 = w . u_{L-1} + b; udf, and dy = d udf / d y0
  wg_head_dot(whead, lay.in[L - 1], cur, reds + wg * 2 * PW, dyv,
              a.B[L - 1], t, 1 + wg);
  if (t < PW) {
    const float y0 = dyv[t];
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
    if (valid) a.udf[p0 + t] = u / lay.scale;
    dyv[t] = dy / lay.scale;
  }
  wg_sync();

  // reverse: the head's transposed product, then W_l^T down to lin0
  for (int h = 0; h < halves(lay.in[L - 1]); ++h) {
    wg_head_outer(acc, whead, lay.in[L - 1], dyv, h, t);
    epi_grad(L - 1, h);
  }
  publish();
  for (int l = L - 2; l >= 1; --l) {
    int N, K;
    prod_shape(wl, l, true, N, K);
    prefetch(l - 1);
    for (int h = 0; h < halves(N); ++h) {
      product_half<1>(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                      full, empty);
      epi_grad(l, h);
    }
    publish();
  }
  {
    int N, K;
    prod_shape(wl, 0, true, N, K);
    for (int h = 0; h < halves(N); ++h) {
      product_half<1>(acc, part, smem_u32(cur), ring_addr, K, stage, phase,
                      full, empty);
      epi_input(h);
    }
  }
  wg_sync();

  // PE Jacobian: du_j = g_j + sum_k f_k (cos(u_j f_k) gs - sin(u_j f_k) gc)
  if (!valid) return;
  const int mr = lay.multires;
  for (int i = t; i < 8 * PW; i += WG) {
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

// Scratch the wrapper allocates, by kernels/mlp_query.py::query_wgmma_plan.
struct Sizes {
  long long wb, side, smem, blocks;
};

Sizes sizes_of(const WLayout& wl, long long n) {
  Sizes s;
  s.blocks = (n + PB - 1) / PB;
  s.wb = (long long)FMAX * wl.ldwb;
  s.side = 2 * s.blocks * (wl.lay.L - 1) * (long long)SIDE;
  s.smem = Q_SMEM;
  return s;
}

}  // namespace

extern "C" {

// The scratch and shared memory of a launch at n points: out[0] bf16
// weight-pack elements, [1] side-array elements, [2] the query kernel's
// dynamic shared bytes, [3] its blocks. 0 on success, 1 on a layout the
// kernels do not take.
int emap_mlp_query_wgmma_sizes(const int* layout, long long n,
                               long long* out) {
  WLayout wl;
  if (parse_query(layout, 1.f, &wl) || n <= 0) return 1;
  const Sizes s = sizes_of(wl, n);
  const long long v[4] = {s.wb, s.side, s.smem, s.blocks};
  for (int i = 0; i < 4; ++i) out[i] = v[i];
  return 0;
}

// pts (8, n), W (rmax, ldw), B (rmax, L) -> udf (n,), grad (8, n); fp32,
// contiguous, on the device; n a multiple of 64; tier BF16. Scratch as
// emap_mlp_query_wgmma_sizes gives it: wb (bf16), side (fp32, or bf16 when
// bf16_side: the sigmoid residuals rounded to bf16). Returns
// cudaErrorInvalidValue on anything else or a tensor map
// cuTensorMapEncodeTiled refuses, else the first nonzero CUDA error (the
// shared-memory opt-in, each launch).
int emap_mlp_query_wgmma(const float* pts, const float* W, const float* B,
                         float* udf, float* grad, void* wb, void* side,
                         long long n, const int* layout, float scale,
                         int tier, int bf16_side, void* stream) {
  WLayout wl;
  if (parse_query(layout, scale, &wl) || n <= 0 || n % PW || tier != BF16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const Sizes sz = sizes_of(wl, n);
  CUtensorMap mw;
  if (bf16_box_map(&mw, wb, FMAX, wl.ldwb)) return (int)cudaErrorInvalidValue;
  const auto kernel =
      bf16_side ? query_kernel<unsigned short> : query_kernel<float>;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Q_SMEM);
  if (err) return err;

  pack_kernel<<<132, 256, 0, st>>>(W, (unsigned short*)wb, wl);
  err = (int)cudaGetLastError();
  if (err) return err;

  QArgs args{pts, W, B, udf, grad, side, n};
  kernel<<<(unsigned)sz.blocks, NTW, Q_SMEM, st>>>(mw, args, wl);
  return (int)cudaGetLastError();
}

}  // extern "C"
