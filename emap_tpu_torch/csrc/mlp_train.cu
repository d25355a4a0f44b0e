// Second-order backward of the fused training field query, on the tensor
// cores.
//
// Replaces: emap_tpu/kernels/mlp_train.py::_pallas_train_bwd with
// fuse_pe=True (per-tile math in _train_bwd_math), the backward of the
// training query's custom_vjp. Given the cotangents ubar (on udf) and gbar
// (on the spatial gradient), it recomputes the forward from the raw points,
// reruns the spatial-gradient chain, runs the ascend/descend adjoint chains
// (equations in emap_tpu/kernels/mlp_train.py:22-36) and sums the packed
// weight/bias gradients over all points. The points get no cotangent.
// Two tiers (mlp_mma.cuh: Tier), as _train_bwd_math takes them: the
// forward recompute and the gradient chain run at the primal tier TP
// (cfg.precision), the ascend and descend products and both weight-gradient
// outer products at the adjoint tier TA (bwd_precision or precision).
// No pair is on the training path any more: kernels/mlp_train.py::
// train_bwd sends the (BF16, BF16) pair every shipped conf trains at to
// mlp_train_wgmma.cu and the others to mlp_train_tf32.cu (wgmma and TMA);
// every instantiation here is reached only by train_bwd_mma_sync, which
// chip_smoke.py times beside them.
//
// Bound on the H100: operations. 12 * sum(in_l * out_l) - 4 * in_0 * out_0
// FLOP a point (5.44 MFLOP at ABC width: forward, gradient chain, ascend,
// descend and the two weight-gradient outer products;
// kernels/mlp_train.py::train_bwd_flops) against 68 bytes a point and
// 2.2 MB of output: at the step's 116,736 points >= 9.5 ms at the fp32 FMA
// peak (67 TFLOP/s), >= 3.85 ms for three TF32 passes at the tensor-core
// peak, >= 0.64 ms for one bf16 pass at 989 TFLOP/s. Every product but the
// head's 1-row ones (fp32 FMA) runs as mma.sync at its tier (mlp_mma.cuh);
// as in mlp_query.cu, the work around the mma (operand splits, barriers,
// epilogues) holds it above the bound.
// Design: the TPU kernel carries the weight-gradient sum in VMEM from one
// grid step to the next; blocks on the H100 run in no order, so the work is
// split in three launches, all deterministic (no atomics, fixed orders):
//   1. per_point: one block per 64-point tile walks the four chains as 30
//      tile products with the tile in shared memory (186 KB at ABC width),
//      keeps sigmoid(100 z_l) and carry/s_hat_l as side arrays in device
//      scratch, and writes each layer's outer-product factors (r_l, qhat_l,
//      zhat_l, u_l) feature-major to it: 12,196 rows x N floats at ABC
//      width (5.69 GB at the step's N);
//   2. wbar_partials: for each 128 x 128 block of each layer's gradient and
//      each of KS fixed point ranges, a block contracts those factors over
//      its points on the tensor cores, W-bar_l = R_l Qhat_l^T + Zhat_l
//      U_l^T with K = points, both factors streamed through a cp.async ring
//      and split as the warps read them (splitting each chunk once into
//      (hi, lo) slots instead measured slower on the H100); the bias rows
//      sum zhat_l from the same ring;
//   3. reduce: the KS partials are summed in a fixed order.

#include "mlp_mma.cuh"

using namespace emap;

namespace {

constexpr int KS = 16;    // point ranges of the weight-gradient contraction
constexpr int BT = 128;   // rows and columns of a wbar_partials block
constexpr int KW = 32;    // points per wbar_partials chunk
constexpr int SWB = KW + 4;  // row stride of a wbar_partials chunk
constexpr int MAXT = MAXL * (WMAX / BT) * (WMAX / BT);

struct BwdScratch {
  float* U[MAXL];   // (in_l) layer inputs; U[0] is the encoded x
  float* QH[MAXL];  // (in_l) q_hat_l; QH[0] is gbar through the PE Jacobian^T
  float* R[MAXL];   // (out_l) spatial-gradient chain r_l; R[L-1] = dy
  float* ZH[MAXL];  // (out_l) z_hat_l
  float* S[MAXL];   // side (out_l) sigmoid(100 z_l), l < L-1
  float* SH[MAXL];  // side (out_l) carry_{l+1}, then s_hat_l, l < L-1
};

long long bwd_carve(const Layout& lay, float* base, size_t ld,
                    BwdScratch* s) {
  long long row = 0;
  auto take = [&](int rows) {
    float* p = base ? base + (size_t)row * ld : nullptr;
    row += rows;
    return p;
  };
  for (int l = 0; l < lay.L; ++l) {
    s->U[l] = take(lay.in[l]);
    s->QH[l] = take(lay.in[l]);
    s->R[l] = take(lay.out[l]);
    s->ZH[l] = take(lay.out[l]);
    const bool hidden = l < lay.L - 1;
    s->S[l] = hidden ? take(side_rows(lay.out[l])) : nullptr;
    s->SH[l] = hidden ? take(side_rows(lay.out[l])) : nullptr;
  }
  return row;
}

template <Tier TP, Tier TA>
__global__ void __launch_bounds__(NT, 1)
    per_point_kernel(const float* pts, const float* __restrict__ W,
                     const float* __restrict__ B, const float* ubar,
                     const float* gbar, BwdScratch s, Layout lay, size_t ld) {
  extern __shared__ float4 smem4[];
  const TileSmem ts = tile_smem(lay);
  float* ring = reinterpret_cast<float*>(smem4);
  float* act = ring + RING;              // (ar, SA) the chain's vector
  float* X = act + (size_t)ts.ar * SA;    // (xr, SA) encoded input
  float* GB = X + (size_t)ts.xr * SA;     // (xr, SA) q_hat_0
  float* red = GB + (size_t)ts.xr * SA;   // (4, P) head partial sums
  float* dyv = red + 4 * P;               // (P) dy, then z_hat_{L-1}
  float* rh = dyv + P;                    // (P) r_hat of the head
  const size_t n0 = (size_t)blockIdx.x * P;
  const int L = lay.L, d0 = lay.d0, mr = lay.multires;
  const Frag f = frag_points();

  // x = PE(points); GB = (dPE/dx)^T gbar, blocked layout; both are layer
  // 0's factors U_0 and Qhat_0
  for (int i = threadIdx.x; i < ts.ar * SA; i += NT) act[i] = 0.f;
  for (int i = threadIdx.x; i < ts.xr * SA; i += NT) {
    const int r = i / SA, p = i % SA;
    float x = 0.f, v = 0.f;
    if (r < lay.d0p && p < P) {
      const size_t n = n0 + p;
      x = encode_row(pts, ld, n, r, lay);
      if (r < 3) {
        v = gbar[(size_t)r * ld + n] * lay.scale;
      } else if (r < 3 + 6 * mr) {
        const bool is_sin = r < 3 + 3 * mr;
        const int q = is_sin ? r - 3 : r - 3 - 3 * mr;
        const int k = q / 3, j = q % 3;
        const float f = (float)(1 << k);
        const float t = gbar[(size_t)j * ld + n] * lay.scale;
        const float uf = pts[(size_t)j * ld + n] * lay.scale * f;
        v = is_sin ? (f * cosf(uf)) * t : ((-f) * sinf(uf)) * t;
      }
      s.U[0][(size_t)r * ld + n] = x;
      s.QH[0][(size_t)r * ld + n] = v;
    }
    X[i] = x;
    GB[i] = v;
  }
  __syncthreads();

  // forward recompute: u_{l+1} = softplus(100 z_l)/100 (x 1/sqrt2 before a
  // skip, with the x rows appended), s_l = sigmoid(100 z_l); dy from the head
  Acc acc;
  for (int l = 0; l < L - 1; ++l) {
    const int M = lay.out[l];
    tc_product<TP, false>(W + lay.off[l], lay.ldw, M, lay.in[l], l ? act : X,
                          ring, acc);
    const bool skip = lay.skip[l + 1] != 0;
    float* S = s.S[l];
    float* U = s.U[l + 1];
    for_groups(M, [&](int mt, int nt) {
      float sig[4], a[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = frag_m(f, mt, e);
        sig[e] = a[e] = 0.f;
        if (m < M) {
          sig_softplus100(acc[mt][nt][e] + B[m * L + l], sig[e], a[e]);
          if (skip) a[e] *= INV_SQRT2;
          act[m * SA + frag_p(f, nt, e)] = a[e];
        }
      }
      *side(S, M, mt, nt) = make_float4(sig[0], sig[1], sig[2], sig[3]);
#pragma unroll
      for (int h = 0; h < 4; h += 2)
        if (frag_m(f, mt, h) < M)
          store2(U, ld, n0, frag_m(f, mt, h), frag_p(f, nt, 0), a[h],
                 a[h + 1]);
    });
    if (skip)
      for (int i = threadIdx.x; i < d0 * P; i += NT) {
        const int r = i / P, p = i % P;
        const float x = X[r * SA + p] * INV_SQRT2;
        act[(M + r) * SA + p] = x;
        U[(size_t)(M + r) * ld + n0 + p] = x;
      }
    __syncthreads();
  }
  head_dot<TP>(W + lay.off[L - 1], lay.in[L - 1], act, red, dyv);
  if (threadIdx.x < P) {
    const float y0 = dyv[threadIdx.x] + B[L - 1];
    float dy;
    if (lay.udf_type == 0) dy = sign_of(y0) / lay.scale;
    else if (lay.udf_type == 1) dy = 2.f * y0 / lay.scale;
    else dy = 1.f / lay.scale;
    dyv[threadIdx.x] = dy;
    s.R[L - 1][n0 + threadIdx.x] = dy;
  }
  __syncthreads();

  // spatial-gradient chain: q = W_l^T r_l, carry = non-x rows of q (scaled
  // at a skip), r_{l-1} = carry * s_{l-1}
  for (int l = L - 1; l >= 1; --l) {
    if (l == L - 1)
      head_outer<TP>(W + lay.off[l], lay.in[l], dyv, acc);
    else
      tc_product<TP, true>(W + lay.off[l], lay.ldw, lay.in[l], lay.out[l],
                           act, ring, acc);
    const bool skip = lay.skip[l] != 0;
    const int c = lay.out[l - 1];  // the non-x rows of q
    const float* S = s.S[l - 1];
    float* SH = s.SH[l - 1];
    float* R = s.R[l - 1];
    for_groups(c, [&](int mt, int nt) {
      const float4 sv = *side(S, c, mt, nt);
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      float carry[4], r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float q = acc[mt][nt][e];
        carry[e] = skip ? q * INV_SQRT2 : q;
        r[e] = carry[e] * sg[e];
        const int m = frag_m(f, mt, e);
        if (m < c) act[m * SA + frag_p(f, nt, e)] = r[e];
      }
      *side(SH, c, mt, nt) =
          make_float4(carry[0], carry[1], carry[2], carry[3]);
#pragma unroll
      for (int h = 0; h < 4; h += 2)
        if (frag_m(f, mt, h) < c)
          store2(R, ld, n0, frag_m(f, mt, h), frag_p(f, nt, 0), r[h],
                 r[h + 1]);
    });
    __syncthreads();
  }

  // ascend: r_hat = W_l q_hat_l; s_hat_l = r_hat * carry_{l+1};
  // q_hat_{l+1} = r_hat * s_l (x 1/sqrt2 before a skip, with the x rows of
  // gbar appended)
  for (int l = 0; l < L - 1; ++l) {
    const int M = lay.out[l];
    tc_product<TA, false>(W + lay.off[l], lay.ldw, M, lay.in[l], l ? act : GB,
                          ring, acc);
    const bool skip = lay.skip[l + 1] != 0;
    const float* S = s.S[l];
    float* SH = s.SH[l];
    float* QH = s.QH[l + 1];
    for_groups(M, [&](int mt, int nt) {
      float4* shp = side(SH, M, mt, nt);
      const float4 cv = *shp, sv = *side(S, M, mt, nt);
      const float carry[4] = {cv.x, cv.y, cv.z, cv.w};
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      float sh[4], q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float r = acc[mt][nt][e];
        sh[e] = r * carry[e];
        const float ch = r * sg[e];
        q[e] = skip ? ch * INV_SQRT2 : ch;
        const int m = frag_m(f, mt, e);
        if (m < M) act[m * SA + frag_p(f, nt, e)] = q[e];
      }
      *shp = make_float4(sh[0], sh[1], sh[2], sh[3]);
#pragma unroll
      for (int h = 0; h < 4; h += 2)
        if (frag_m(f, mt, h) < M)
          store2(QH, ld, n0, frag_m(f, mt, h), frag_p(f, nt, 0), q[h],
                 q[h + 1]);
    });
    if (skip)
      for (int i = threadIdx.x; i < d0 * P; i += NT) {
        const int r = i / P, p = i % P;
        const float g = GB[r * SA + p] * INV_SQRT2;
        act[(M + r) * SA + p] = g;
        QH[(size_t)(M + r) * ld + n0 + p] = g;
      }
    __syncthreads();
  }
  head_dot<TA>(W + lay.off[L - 1], lay.in[L - 1], act, red, rh);

  // descend: z_hat_{L-1} = ubar * dy (+ r_hat * 2/scale, square head);
  // a_hat = non-x rows of W_l^T z_hat_l (scaled at a skip);
  // z_hat_{l-1} = a_hat * s + s_hat * (100 s (1 - s))
  if (threadIdx.x < P) {
    const size_t n = n0 + threadIdx.x;
    float z = ubar[n] * dyv[threadIdx.x];
    if (lay.udf_type == 1) z = z + rh[threadIdx.x] * (2.f / lay.scale);
    dyv[threadIdx.x] = z;
    s.ZH[L - 1][n] = z;
  }
  __syncthreads();
  for (int l = L - 1; l >= 1; --l) {
    if (l == L - 1)
      head_outer<TA>(W + lay.off[l], lay.in[l], dyv, acc);
    else
      tc_product<TA, true>(W + lay.off[l], lay.ldw, lay.in[l], lay.out[l],
                           act, ring, acc);
    const bool skip = lay.skip[l] != 0;
    const int c = lay.out[l - 1];  // the non-x rows of W_l^T z_hat_l
    const float* S = s.S[l - 1];
    const float* SH = s.SH[l - 1];
    float* ZH = s.ZH[l - 1];
    for_groups(c, [&](int mt, int nt) {
      const float4 sv = *side(S, c, mt, nt), hv = *side(SH, c, mt, nt);
      const float sg[4] = {sv.x, sv.y, sv.z, sv.w};
      const float sh[4] = {hv.x, hv.y, hv.z, hv.w};
      float z[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float uh = acc[mt][nt][e];
        const float a = skip ? uh * INV_SQRT2 : uh;
        z[e] = a * sg[e] + sh[e] * ((100.f * sg[e]) * (1.f - sg[e]));
        const int m = frag_m(f, mt, e);
        if (m < c) act[m * SA + frag_p(f, nt, e)] = z[e];
      }
#pragma unroll
      for (int h = 0; h < 4; h += 2)
        if (frag_m(f, mt, h) < c)
          store2(ZH, ld, n0, frag_m(f, mt, h), frag_p(f, nt, 0), z[h],
                 z[h + 1]);
    });
    __syncthreads();
  }
}

// One 128 x 128 output block of one layer's weight gradient.
struct WTile {
  int l, o0, i0;
};
struct WTiles {
  int count;
  WTile t[MAXT];
};

// Per (tile, point range): wpart[split][o][off_l + i] =
//   sum_n r_l[o,n] qhat_l[i,n] + zhat_l[o,n] u_l[i,n]
// with the products at the adjoint tier TA and, for the tiles at i0 = 0,
// bpart[split][o][l] = sum_n zhat_l[o,n] in fp32.
template <Tier TA>
__global__ void __launch_bounds__(NT, 1)
    wbar_partials_kernel(BwdScratch s, Layout lay, size_t ld, WTiles tiles,
                         size_t chunk, float* wpart, float* bpart) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // 2 x (A, B) chunks
  const WTile t = tiles.t[blockIdx.x];
  const int l = t.l, o0 = t.o0, i0 = t.i0;
  const int out = lay.out[l], in = lay.in[l];
  const size_t nb = (size_t)blockIdx.y * chunk;
  const size_t ne = nb + chunk < ld ? nb + chunk : ld;
  const int nch = nb < ne ? (int)((ne - nb) / KW) : 0;  // per factor pair
  const bool bias = i0 == 0;
  const Frag f = frag_wbar();
  constexpr int SLOT2 = 2 * BT * SWB;

  auto load = [&](int c) {
    float* a = ring + (c & 1) * SLOT2;
    float* b = a + BT * SWB;
    const bool second = c >= nch;
    const size_t n = nb + (size_t)(second ? c - nch : c) * KW;
    const float* Ap = second ? s.ZH[l] : s.R[l];
    const float* Bp = second ? s.U[l] : s.QH[l];
    for (int q = threadIdx.x; q < BT * (KW / 4); q += NT) {
      const int r = q / (KW / 4), kk = (q % (KW / 4)) * 4;
      const bool oka = o0 + r < out, okb = i0 + r < in;
      cp16(a + r * SWB + kk, oka ? Ap + (size_t)(o0 + r) * ld + n + kk : Ap,
           oka);
      cp16(b + r * SWB + kk, okb ? Bp + (size_t)(i0 + r) * ld + n + kk : Bp,
           okb);
    }
    cp_commit();
  };

  Acc acc;
  zero_acc(acc);
  float bsum = 0.f;  // thread's half of row tid / 2's z_hat sum
  const int total = 2 * nch;
  if (total > 0) load(0);
  for (int c = 0; c < total; ++c) {
    // chunk c has landed for every thread, and every warp is past chunk
    // c - 1, whose slot the next load takes
    cp_wait<0>();
    __syncthreads();
    if (c + 1 < total) load(c + 1);
    const float* a = ring + (c & 1) * SLOT2;
    const float* b = a + BT * SWB;
    Acc part;
    zero_acc(part);
    mma_chunk<TA, KW>(
        part, f, out - o0, [&](int m, int kk) { return a[m * SWB + kk]; },
        [&](int kk, int i) { return b[i * SWB + kk]; });
    add_acc(acc, part);
    if (bias && c >= nch) {
      const float* row = a + (threadIdx.x >> 1) * SWB + (threadIdx.x & 1) * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j) bsum += row[j];
    }
  }
  __syncthreads();

  float* wp = wpart + (size_t)blockIdx.y * lay.rmax * lay.ldw;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + frag_m(f, mt, e), i = i0 + frag_p(f, nt, e);
        if (o < out && i < in)
          wp[(size_t)o * lay.ldw + lay.off[l] + i] = acc[mt][nt][e];
      }
  if (bias) {
    ring[threadIdx.x] = bsum;  // every read of the ring has ended
    __syncthreads();
    const int o = o0 + (int)threadIdx.x;
    if (threadIdx.x < BT && o < out)
      bpart[(size_t)blockIdx.y * lay.rmax * lay.L + o * lay.L + l] =
          ring[2 * threadIdx.x] + ring[2 * threadIdx.x + 1];
  }
}

// out[e] = sum over the KS partials, in a fixed order
__global__ void reduce_partials_kernel(const float* part, float* out,
                                       size_t count) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int k = 0; k < KS; ++k) v += part[(size_t)k * count + e];
    out[e] = v;
  }
}

// The three launches at tiers (TP, TA); the partials are zeroed between the
// first two.
template <Tier TP, Tier TA>
int launch(const float* pts, const float* W, const float* B,
           const float* ubar, const float* gbar, float* wbar, float* bbar,
           const BwdScratch& s, float* partials, const Layout& lay,
           long long n, cudaStream_t st) {
  const size_t pp_bytes = tile_smem(lay).floats() * sizeof(float);
  const size_t wb_bytes = 2 * 2 * BT * SWB * sizeof(float);
  int err = (int)cudaFuncSetAttribute(
      per_point_kernel<TP, TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)pp_bytes);
  if (!err)
    err = (int)cudaFuncSetAttribute(
        wbar_partials_kernel<TA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)wb_bytes);
  if (err) return err;
  per_point_kernel<TP, TA><<<(unsigned)(n / P), NT, pp_bytes, st>>>(
      pts, W, B, ubar, gbar, s, lay, (size_t)n);
  err = (int)cudaGetLastError();
  if (err) return err;

  const size_t wcount = (size_t)lay.rmax * lay.ldw;
  const size_t bcount = (size_t)lay.rmax * lay.L;
  float* wpart = partials;
  float* bpart = partials + (size_t)KS * wcount;
  err = (int)cudaMemsetAsync(partials, 0,
                             (size_t)KS * (wcount + bcount) * sizeof(float), st);
  if (err) return err;
  WTiles tiles;
  tiles.count = 0;
  for (int l = 0; l < lay.L; ++l)
    for (int o0 = 0; o0 < lay.out[l]; o0 += BT)
      for (int i0 = 0; i0 < lay.in[l]; i0 += BT)
        tiles.t[tiles.count++] = WTile{l, o0, i0};
  const size_t chunk =
      ((size_t)(n + KS - 1) / KS + KW - 1) / KW * KW;  // multiple of KW
  wbar_partials_kernel<TA><<<dim3(tiles.count, KS), NT, wb_bytes, st>>>(
      s, lay, (size_t)n, tiles, chunk, wpart, bpart);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_partials_kernel<<<264, NT, 0, st>>>(wpart, wbar, wcount);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_partials_kernel<<<8, NT, 0, st>>>(bpart, bbar, bcount);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Scratch the wrapper allocates: rows (x n floats) of per-point factors and
// the floats of the weight/bias partials. 0 on success, 1 on a layout the
// kernels do not take.
int emap_mlp_train_bwd_sizes(const int* layout, long long* scratch_rows,
                             long long* partial_floats) {
  Layout lay;
  if (parse_tc(layout, 1.f, &lay)) return 1;
  BwdScratch s;
  *scratch_rows = bwd_carve(lay, nullptr, 0, &s);
  *partial_floats = (long long)KS * lay.rmax * (lay.ldw + lay.L);
  return 0;
}

// pts (8, n), W (rmax, ldw), B (rmax, L), ubar (n,), gbar (8, n)
// -> wbar (rmax, ldw), bbar (rmax, L); fp32, contiguous, on the device; n a
// multiple of 64; tier (primal) and adjoint_tier Tier codes. Returns
// cudaErrorInvalidValue on anything else, else the first nonzero CUDA
// error (shared-memory opt-ins, launches, the partials' memset).
int emap_mlp_train_bwd(const float* pts, const float* W, const float* B,
                       const float* ubar, const float* gbar, float* wbar,
                       float* bbar, float* scratch, float* partials,
                       long long n, const int* layout, float scale, int tier,
                       int adjoint_tier, void* stream) {
  Layout lay;
  if (parse_tc(layout, scale, &lay) || n <= 0 || n % P)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  BwdScratch s;
  bwd_carve(lay, scratch, (size_t)n, &s);
#define EMAP_TRAIN_LAUNCH(TP, TA)                                       \
  if (tier == TP && adjoint_tier == TA)                                 \
    return launch<TP, TA>(pts, W, B, ubar, gbar, wbar, bbar, s, partials, \
                          lay, n, st);
  EMAP_TRAIN_LAUNCH(TF32X3, TF32X3)
  EMAP_TRAIN_LAUNCH(TF32X3, BF16)
  EMAP_TRAIN_LAUNCH(BF16, TF32X3)
  EMAP_TRAIN_LAUNCH(BF16, BF16)
#undef EMAP_TRAIN_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
