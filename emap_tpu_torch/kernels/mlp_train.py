"""The training field query: fused value + spatial gradient with a
hand-derived second-order backward (port of emap_tpu/kernels/mlp_train.py).

* `train_bwd_plain`: plain PyTorch version of the backward, the math of
  `_train_bwd_math` with the fused PE encode in front. Given cotangents
  ubar (on udf) and gbar (on the spatial gradient) it recomputes the
  forward, reruns the spatial-gradient chain and runs the adjoint chains:

    forward   z_l = W_l u_l + b_l,  a_l = softplus(100 z)/100,
              s_l = sigmoid(100 z_l);  u_l = [a_{l-1}; x]/sqrt(2) at skips
    grad      r_{L-1} = dy;  q_l = W_l^T r_l;  r_{l-1} = carry_l * s_{l-1}
    ascend    Wbar_l += r_l q_hat^T;  r_hat_l = W_l q_hat;
              s_hat_l = r_hat_l * carry_{l+1};  carryhat = r_hat_l * s_l
    descend   z_hat_{L-1} = ubar * dy (+ 2/scale * r_hat for the square head);
              z_hat_l = a_hat_l * s_l + s_hat_l * 100 s_l (1 - s_l);
              Wbar_l += z_hat_l u_l^T;  bbar_l += sum z_hat_l;
              a_hat_{l-1} = non-x rows of W_l^T z_hat_l (scaled at skips)

  The forward recompute and the gradient chain run at cfg.precision, the
  adjoint products (ascend, descend, both weight-gradient outer products)
  at the adjoint tier, bwd_precision or else precision
  (fields/udf.py::adjoint_tier), as `_train_bwd_math` runs them.
* `train_bwd`: the wrapper. CPU tensors take the plain version; CUDA
  tensors launch the kernels that replace
  emap_tpu/kernels/mlp_train.py::_pallas_train_bwd, or raise: at the
  (bf16, bf16) pair every shipped conf trains at, csrc/mlp_train_wgmma.cu
  (wgmma and TMA: a weight-pack prologue, the per-point chains writing the
  weight-gradient factors in bf16, a GEMM over them, a fixed-order
  reduce); at the pairs with a 3xTF32 tier (3xTF32, and the mixed ones),
  csrc/mlp_train_tf32.cu (wgmma .tf32 and TMA: the pre-split 3xTF32 pack
  and, at a bf16 tier, the bf16 one; the per-point chains on one fp32
  tile, writing the factors in fp32 at a 3xTF32 adjoint and in bf16 at a
  bf16 one; the 3xTF32 GEMM or the bf16 one; the reduce).
  `train_bwd.launches` counts the kernel launches, `train_bwd.tier_launches`
  the same by (primal, adjoint) tier pair (`pair_name`).
  `train_bwd_mma_sync` runs csrc/mlp_train.cu's mma.sync design at any
  pair, for timing beside the wgmma kernels; the training path never
  calls it.
* The wgmma kernels' Python side: `wgmma_layout` and `pack_weights_bf16`
  (their weight pack and factor rows, and the prologue's plain version;
  kernels/mlp_query.py, shared with #1a's wgmma kernel), `wgmma_plan`
  (shared memory, registers and scratch of a launch; refuses a net that
  does not fit), `train_bwd_factors` and `wbar_from_factors`
  (the per-point kernel's and the GEMM's plain versions: factors stored as
  bf16 lose nothing at the bf16 adjoint tier) and `train_bwd_launch_costs`
  (FLOP and bytes of each launch). Those of csrc/mlp_train_tf32.cu:
  `train_tf32_plan`, `train_tf32_launch_costs`, `wbar_tf32_from_factors`
  (its 3xTF32 GEMM's plain version, with the kernel's sum order) and
  `train_bwd_tf32_parts`.
* `TrainQuery`: the autograd.Function joining the two (forward =
  mlp_query.value_and_grad, backward = train_bwd), the counterpart of the
  JAX package's `_train_query` custom_vjp.
* `udf_train_value_and_gradient`: the drop-in for
  fields.udf.udf_value_and_gradient inside render_core.

The points get NO cotangent, by design: in render_core they depend only on
no-grad z values and rays. `udf_train_value_and_gradient` detaches them so a
caller whose points did carry a gradient cannot get a silently wrong one.
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from emap_tpu_torch.fields.udf import UDFConfig, adjoint_tier, softplus100
from emap_tpu_torch.kernels import mlp_query
from emap_tpu_torch.kernels.mlp_query import (
    INV_SQRT2,
    POINT_TILE,
    SMEM_LIMIT,
    TIER_NAMES,
    WGMMA_BLOCK_POINTS,
    WGMMA_FMAX,
    check_operands,
    dy_of_y0,
    encode_fused,
    kernel_layout,
    kernel_tier,
    layer_dims,
    pack_weights,
    pack_weights_bf16,
    pe_jacT_fused,
    tier_dot,
    unpack_weights,
    wgmma_layout,
)


def pair_name(primal: int, adjoint: int) -> str:
    """The name of a (primal, adjoint) pair of kernel tier codes:
    "bf16", "3xtf32", or "3xtf32+bf16" for a 3xTF32 primal and a bf16
    adjoint."""
    if primal == adjoint:
        return TIER_NAMES[primal]
    return f"{TIER_NAMES[primal]}+{TIER_NAMES[adjoint]}"


def _bwd_factors(x, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """The chains of the backward: x (d0_pad, T) encoded, ubar (1, T), gbar
    (d0_pad, T) encoded-space -> per layer the weight-gradient factors
    (r_l, q_hat_l, z_hat_l, u_l) in fp32, W-bar_l = r_l q_hat_l^T + z_hat_l
    u_l^T, and b-bar_l = sum z_hat_l (out_l, 1). Primal products at
    cfg.precision, adjoint products at adjoint_tier(cfg)."""
    tp, ta = cfg.precision, adjoint_tier(cfg)
    layers = unpack_weights(w_pack, b_pack, cfg)
    L = len(layers)
    d0 = cfg.dims[0]

    def W(l):
        return layers[l][0]

    zs, us = [], []
    h = x
    for l in range(L):
        if l in cfg.skip_in:
            h = torch.cat([h, x[:d0]], dim=0) * INV_SQRT2
        us.append(h)
        z = tier_dot(W(l), h, tp) + layers[l][1][:, None]
        if l < L - 1:
            zs.append(z)
            h = softplus100(z)
        else:
            y0 = z[:1]
    dy = dy_of_y0(y0, cfg)
    ss = [torch.sigmoid(100.0 * z) for z in zs]

    carries = [None] * L
    r = dy
    for l in reversed(range(1, L)):
        q = tier_dot(W(l).T, r, tp)
        carry = q[:-d0] * INV_SQRT2 if l in cfg.skip_in else q
        carries[l] = carry
        r = carry * ss[l - 1]

    def r_of(l):
        return dy if l == L - 1 else carries[l + 1] * ss[l]

    q_hats = [None] * L
    z_hats = [None] * L
    b_contrib = [None] * L
    s_hat = [None] * (L - 1)
    carryhat = r_hat_last = None
    for l in range(L):
        if l == 0:
            q_hat = gbar
        elif l in cfg.skip_in:
            q_hat = torch.cat([carryhat * INV_SQRT2, gbar[:d0] * INV_SQRT2],
                              dim=0)
        else:
            q_hat = carryhat
        q_hats[l] = q_hat
        r_hat = tier_dot(W(l), q_hat, ta)
        if l < L - 1:
            s_hat[l] = r_hat * carries[l + 1]
            carryhat = r_hat * ss[l]
        else:
            r_hat_last = r_hat

    a_hat = None
    for l in reversed(range(L)):
        if l == L - 1:
            z_hat = ubar * dy
            if cfg.udf_type == "square":
                z_hat = z_hat + r_hat_last * (2.0 / cfg.scale)
        else:
            s = ss[l]
            z_hat = a_hat * s + s_hat[l] * (100.0 * s * (1.0 - s))
        z_hats[l] = z_hat
        b_contrib[l] = torch.sum(z_hat, dim=1, keepdim=True)
        if l == 0:
            break
        u_hat = tier_dot(W(l).T, z_hat, ta)
        a_hat = u_hat[:-d0] * INV_SQRT2 if l in cfg.skip_in else u_hat
    return ([(r_of(l), q_hats[l], z_hats[l], us[l]) for l in range(L)],
            b_contrib)


def _packed_grads(w_contrib, b_contrib, row_max):
    def pad(a):
        return torch.nn.functional.pad(a, (0, 0, 0, row_max - a.shape[0]))

    return (torch.cat([pad(w) for w in w_contrib], dim=1),
            torch.cat([pad(b) for b in b_contrib], dim=1))


def _train_bwd_math(x, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """x (d0_pad, T) encoded, ubar (1, T), gbar (d0_pad, T) encoded-space
    -> (wbar (row_max, sum_in), bbar (row_max, L)). Primal products at
    cfg.precision, adjoint products at adjoint_tier(cfg)."""
    ta = adjoint_tier(cfg)
    factors, b_contrib = _bwd_factors(x, w_pack, b_pack, ubar, gbar, cfg)
    w_contrib = [tier_dot(r, q_hat.T, ta) + tier_dot(z_hat, u.T, ta)
                 for r, q_hat, z_hat, u in factors]
    return _packed_grads(w_contrib, b_contrib, w_pack.shape[0])


def train_bwd_plain(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """Plain PyTorch version of the backward: x_T (8, N) raw points,
    ubar (1, N), gbar (8, N) -> (wbar, bbar) packed like w_pack/b_pack."""
    x, uf = encode_fused(x_T, cfg)
    gb = pe_jacT_fused(uf, gbar, cfg)
    return _train_bwd_math(x, w_pack, b_pack, ubar, gb, cfg)


# csrc/mlp_train_wgmma.cu's GEMM point ranges; its widest layer, points a
# per-point block and a block's shared memory are the chain engine's
# (kernels/mlp_query.py).
WGMMA_KS = 4


def wgmma_plan(cfg: UDFConfig, n: int) -> dict:
    """Shared memory, registers and device scratch of one launch of the
    wgmma kernels at n points, as csrc/mlp_train_wgmma.cu reckons them
    (emap_mlp_train_wgmma_sizes). Raises ValueError for a net they do not
    take, on every device: a layer wider than WGMMA_FMAX, or a plan past
    the block's shared memory."""
    lay = mlp_query.check_engine_cfg(cfg)
    dims = lay["dims"]
    box = 64 * 64 * 2
    per_point = dict(mlp_query.engine_smem(), **{
        "bias sums (8 warps x 256 fp32)": 8 * WGMMA_FMAX * 4,
        "head vectors and sums": (2 * 3 * 64 + 2 * 2 * 64) * 4,
    })
    gemm = {"factor ring (4 stages of 128 x 64 bf16 of each factor)":
            4 * 4 * box, "mbarriers": 2 * 4 * 8, "alignment": 1024}
    smem = {"per_point": sum(per_point.values()), "gemm": sum(gemm.values())}
    for name, total in smem.items():
        if total > SMEM_LIMIT:
            raise ValueError(f"the wgmma {name} kernel needs {total} bytes "
                             f"of shared memory, more than {SMEM_LIMIT}")
    blocks = -(-n // WGMMA_BLOCK_POINTS)
    L = len(dims)
    rmax = max(o for _, o in dims)
    ldw = sum(i for i, _ in dims)
    return {
        "smem": smem, "per_point_smem": per_point, "gemm_smem": gemm,
        "registers": dict(mlp_query.ENGINE_REGISTERS),
        "blocks": blocks,
        "wb": WGMMA_FMAX * lay["ldwb"],
        "frows": lay["frows"],
        "side": 2 * blocks * (L - 1) * 2 * WGMMA_FMAX * 64,
        "partials": WGMMA_KS * rmax * ldw + blocks * rmax * L,
    }


def train_bwd_factors(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """The per-point kernels' plain version: (F, bbar) with F (frows, N)
    the weight-gradient factors as the kernels store them (rows of
    wgmma_layout: U_l, Q-hat_l, R_l, Z-hat_l, padding rows zero), each
    rounded to bf16 at a bf16 adjoint tier and fp32 at a 3xTF32 one, and
    bbar the bias gradient summed from the fp32 z-hat, at cfg's tiers."""
    x, uf = encode_fused(x_T, cfg)
    gb = pe_jacT_fused(uf, gbar, cfg)
    factors, b_contrib = _bwd_factors(x, w_pack, b_pack, ubar, gb, cfg)
    lay = wgmma_layout(cfg)
    dtype = (torch.bfloat16 if kernel_tier(adjoint_tier(cfg))
             else torch.float32)
    F = torch.zeros(lay["frows"], x_T.shape[1], dtype=dtype,
                    device=x_T.device)
    for l, (r, q_hat, z_hat, u) in enumerate(factors):
        for name, v in (("U", u), ("Q", q_hat), ("R", r), ("Z", z_hat)):
            row = lay["rows"][name][l]
            F[row: row + v.shape[0]] = v.to(dtype)
    row_max = w_pack.shape[0]
    bbar = torch.cat([torch.nn.functional.pad(b, (0, 0, 0, row_max
                                                  - b.shape[0]))
                      for b in b_contrib], dim=1)
    return F, bbar


def wbar_from_factors(F, cfg: UDFConfig):
    """The GEMMs' plain version: W-bar packed like pack_weights from the
    factors F of train_bwd_factors, W-bar_l = R_l Q-hat_l^T + Z-hat_l
    U_l^T with fp32 products and sums of F's values (bf16 or fp32)."""
    lay = wgmma_layout(cfg)
    dims = lay["dims"]
    row_max = max(o for _, o in dims)

    def block(name, l, size):
        row = lay["rows"][name][l]
        return F[row: row + size].to(torch.float32)

    w_contrib = [torch.matmul(block("R", l, o), block("Q", l, i).T)
                 + torch.matmul(block("Z", l, o), block("U", l, i).T)
                 for l, (i, o) in enumerate(dims)]
    return _packed_grads(w_contrib, [torch.zeros(o, 1, device=F.device)
                                     for _, o in dims], row_max)[0]


def train_bwd_launch_costs(cfg: UDFConfig, n: int) -> dict:
    """Each launch of the wgmma kernels at n points: the FLOP of its
    products (2 * in * out each, unpadded shapes) and the bytes it must
    move (each input read once, each output written once), and the side
    arrays' device traffic of the per-point kernel beside them."""
    lay = wgmma_layout(cfg)
    dims = lay["dims"]
    shapes = [(i, o) for _, i, o in cfg.layer_shapes()]
    total = sum(i * o for i, o in shapes)
    first = shapes[0][0] * shapes[0][1]
    L, rmax, ldw = len(dims), max(o for _, o in dims), sum(
        i for i, _ in dims)
    blocks = -(-n // WGMMA_BLOCK_POINTS)
    f32, bf16 = 4, 2
    w_bytes, wb_bytes = f32 * rmax * ldw, bf16 * WGMMA_FMAX * lay["ldwb"]
    b_bytes, factor_bytes = f32 * rmax * L, bf16 * lay["frows"] * n
    bpart = f32 * blocks * rmax * L
    wpart = f32 * WGMMA_KS * rmax * ldw
    # sigmoid(100 z_l) written once and read three times; carry_{l+1}
    # written, read, overwritten by s-hat_l and read: 8 passes over the
    # 128-wide halves of each hidden layer's out_l features a point
    side = 8 * f32 * n * sum(-(-o // 128) * 128 for _, o in dims[:-1])
    return {
        "pack": {"flops": 0, "bytes": w_bytes + wb_bytes},
        "per_point": {"flops": 2 * (4 * total - 2 * first) * n,
                      "bytes": f32 * 17 * n + wb_bytes + b_bytes
                      + factor_bytes + bpart, "side_bytes": side},
        "gemm": {"flops": 4 * total * n, "bytes": factor_bytes + wpart},
        "reduce": {"flops": 0, "bytes": wpart + bpart + w_bytes + b_bytes},
    }


# csrc/mlp_train_tf32.cu, #2 at the pairs with a 3xTF32 tier: a per-point
# block is 64 points, a producer thread and two consumer warpgroups (one
# 128-wide half of each product's outputs each) on one fp32 activation
# tile, fed by a ring of TRAIN_TF32_STAGES weight entries of 32 KB (128
# outputs x 32 contraction steps of the 3xTF32 pack, hi and lo, or 128 x 64
# of the bf16 pack); its 3xTF32 GEMM streams 32-point chunks of 128 rows of
# each fp32 factor and a lo copy of the B rows through a ring of as many
# stages.
TRAIN_TF32_BLOCK_POINTS = 64
TRAIN_TF32_STAGES = 4


def _pair_of(cfg: UDFConfig) -> tuple:
    return kernel_tier(cfg.precision), kernel_tier(adjoint_tier(cfg))


def train_tf32_plan(cfg: UDFConfig, n: int) -> dict:
    """Shared memory, registers and device scratch of one launch of
    csrc/mlp_train_tf32.cu at n points at cfg's pair of tiers, as the
    library reckons them (emap_mlp_train_tf32_sizes). Raises ValueError, on
    every device, for a pair it does not run (the (bf16, bf16) one), a net
    it does not take (check_engine_cfg: a layer wider than WGMMA_FMAX) or a
    plan past the block's shared memory."""
    pair = _pair_of(cfg)
    if pair == (1, 1):
        raise ValueError("csrc/mlp_train_tf32.cu runs the pairs with a "
                         "3xTF32 tier; the (bf16, bf16) one is "
                         "mlp_train_wgmma.cu's")
    lay = mlp_query.check_engine_cfg(cfg)
    tl = mlp_query.query_tf32_layout(cfg)
    dims = lay["dims"]
    entry = 2 * 128 * mlp_query.TF32_CHUNK * 4  # hi and lo: 32 KB
    per_point = {
        f"weight ring ({TRAIN_TF32_STAGES} stages of 128 x 32 fp32 hi and lo,"
        " or 128 x 64 bf16)": TRAIN_TF32_STAGES * entry,
        "activation tile (64 points x 256 fp32)": 64 * WGMMA_FMAX * 4,
        "bias sums (2 halves x 4 warps x 128 fp32)": 2 * 4 * 128 * 4,
        "head vectors and sums": (3 * 64 + 4 * 64) * 4,
        "mbarriers": 2 * TRAIN_TF32_STAGES * 8, "alignment": 1024,
    }
    if pair[1]:  # a bf16 adjoint: mlp_train_gemm.cuh's GEMM
        gemm = wgmma_plan(cfg, n)["gemm_smem"]
    else:
        gemm = {
            f"factor ring ({TRAIN_TF32_STAGES} stages of 32 points x 128 rows"
            " of each fp32 factor)": TRAIN_TF32_STAGES * entry,
            f"the B rows' lo half ({TRAIN_TF32_STAGES} stages)":
                TRAIN_TF32_STAGES * entry // 2,
            "mbarriers": 3 * TRAIN_TF32_STAGES * 8, "alignment": 1024,
        }
    smem = {"per_point": sum(per_point.values()), "gemm": sum(gemm.values())}
    for name, total in smem.items():
        if total > SMEM_LIMIT:
            raise ValueError(f"the 3xTF32 {name} kernel needs {total} bytes "
                             f"of shared memory, more than {SMEM_LIMIT}")
    blocks = -(-n // TRAIN_TF32_BLOCK_POINTS)
    L = len(dims)
    rmax = max(o for _, o in dims)
    ldw = sum(i for i, _ in dims)
    return {
        "smem": smem, "per_point_smem": per_point, "gemm_smem": gemm,
        "registers": dict(mlp_query.TF32_REGISTERS), "blocks": blocks,
        "pack": 2 * WGMMA_FMAX * tl["ldp"],
        "wb": WGMMA_FMAX * lay["ldwb"] if 1 in pair else 0,
        "frows": lay["frows"],
        "factor_dtype": torch.bfloat16 if pair[1] else torch.float32,
        # sigmoid and carry / s-hat of each hidden layer: WGMMA_FMAX fp32 a
        # point each
        "side": blocks * (L - 1) * 2 * WGMMA_FMAX * 64,
        "partials": WGMMA_KS * rmax * ldw + blocks * rmax * L,
    }


def train_tf32_launch_costs(cfg: UDFConfig, n: int) -> dict:
    """Each launch of csrc/mlp_train_tf32.cu at n points at cfg's pair: the
    FLOP of its products (2 * in * out each, unpadded shapes; the per-point
    kernel's split by tier as `tier_flops`, (primal, adjoint)) and the bytes
    it must move (each input read once, each output written once), and the
    per-point kernel's side-array traffic beside them (sigmoid written
    once and read three times, carry then s-hat written twice and read
    twice, the live 8-feature groups of each hidden layer). The bf16 pack
    launches at a bf16 tier only."""
    primal, adjoint = _pair_of(cfg)
    lay = wgmma_layout(cfg)
    tl = mlp_query.query_tf32_layout(cfg)
    dims = lay["dims"]
    shapes = [(i, o) for _, i, o in cfg.layer_shapes()]
    total = sum(i * o for i, o in shapes)
    first = shapes[0][0] * shapes[0][1]
    L, rmax, ldw = len(dims), max(o for _, o in dims), sum(
        i for i, _ in dims)
    blocks = -(-n // TRAIN_TF32_BLOCK_POINTS)
    f32, bf16 = 4, 2
    w_bytes, b_bytes = f32 * rmax * ldw, f32 * rmax * L
    pk_bytes = f32 * 2 * WGMMA_FMAX * tl["ldp"]
    wb_bytes = bf16 * WGMMA_FMAX * lay["ldwb"] if 1 in (primal, adjoint) else 0
    factor_bytes = (bf16 if adjoint else f32) * lay["frows"] * n
    bpart = f32 * blocks * rmax * L
    wpart = f32 * WGMMA_KS * rmax * ldw
    side = 8 * f32 * n * sum(mlp_query.round_up(o, 8) for _, o in dims[:-1])
    chain = 2 * (2 * total - first) * n  # one tier's two chains
    costs = {
        "pack": {"flops": 0, "bytes": w_bytes + pk_bytes},
        "per_point": {"flops": 2 * chain, "tier_flops": (chain, chain),
                      "bytes": f32 * 17 * n + pk_bytes + wb_bytes + b_bytes
                      + factor_bytes + bpart, "side_bytes": side},
        "gemm": {"flops": 4 * total * n, "bytes": factor_bytes + wpart},
        "reduce": {"flops": 0, "bytes": wpart + bpart + w_bytes + b_bytes},
    }
    if wb_bytes:
        costs["pack_bf16"] = {"flops": 0, "bytes": w_bytes + wb_bytes}
    return costs


def wbar_tf32_from_factors(F, cfg: UDFConfig):
    """The 3xTF32 GEMM's plain version, in its sum order: W-bar packed like
    pack_weights from fp32 factors F (train_bwd_factors at a 3xTF32
    adjoint), each of the WGMMA_KS point ranges contracting [R_l, Z-hat_l]
    against [Q-hat_l, U_l] in 32-point chunks (mlp_query.tf32x3_matmul:
    lo*hi, hi*lo, hi*hi, a fresh accumulator a chunk), the ranges' partials
    then added in order."""
    lay = wgmma_layout(cfg)
    dims = lay["dims"]
    n = F.shape[1]
    chunk = mlp_query.round_up(-(-n // WGMMA_KS), 64)
    row_max = max(o for _, o in dims)

    def block(name, l, size, s):
        row = lay["rows"][name][l]
        return F[row: row + size, s: s + chunk].to(torch.float32)

    w_contrib = []
    for l, (i, o) in enumerate(dims):
        acc = None
        for s in range(0, WGMMA_KS * chunk, chunk):
            a = torch.cat([block("R", l, o, s), block("Z", l, o, s)], dim=1)
            b = torch.cat([block("Q", l, i, s), block("U", l, i, s)], dim=1)
            part = (mlp_query.tf32x3_matmul(a, b.T) if a.shape[1]
                    else torch.zeros(o, i, device=F.device))
            acc = part if acc is None else acc + part
        w_contrib.append(acc)
    return _packed_grads(w_contrib, [torch.zeros(o, 1, device=F.device)
                                     for _, o in dims], row_max)[0]


def _train_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_train")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_train_bwd_sizes.argtypes = [vp, vp, vp]
        lib.emap_mlp_train_bwd_sizes.restype = ctypes.c_int
        lib.emap_mlp_train_bwd.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong, vp,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, vp]
        lib.emap_mlp_train_bwd.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def _wgmma_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_train_wgmma")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_train_wgmma_sizes.argtypes = [vp, ctypes.c_longlong, vp]
        lib.emap_mlp_train_wgmma_sizes.restype = ctypes.c_int
        lib.emap_mlp_train_wgmma.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, ctypes.c_longlong,
            vp, ctypes.c_float, ctypes.c_int, ctypes.c_int, vp]
        lib.emap_mlp_train_wgmma.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def _tf32_lib():
    from emap_tpu_torch.kernels import build

    lib = build.load("mlp_train_tf32")
    if not getattr(lib, "_emap_typed", False):
        vp = ctypes.c_void_p
        lib.emap_mlp_train_tf32_sizes.argtypes = [
            vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp]
        lib.emap_mlp_train_tf32_sizes.restype = ctypes.c_int
        lib.emap_mlp_train_tf32.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            ctypes.c_longlong, vp, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            vp]
        lib.emap_mlp_train_tf32.restype = ctypes.c_int
        lib._emap_typed = True
    return lib


def train_tf32_sizes(cfg: UDFConfig, n: int) -> dict:
    """csrc/mlp_train_tf32.cu's own reckoning of a launch at n points at
    cfg's pair (card only; the CPU reckons train_tf32_plan): pack, wb,
    frows, side, partials, per_point_smem, gemm_smem, blocks."""
    out = (ctypes.c_longlong * 8)()
    if _tf32_lib().emap_mlp_train_tf32_sizes(
            kernel_layout(cfg).ctypes.data, n, *_pair_of(cfg), out):
        raise ValueError("layout or pair refused by the 3xTF32 kernels")
    return dict(zip(("pack", "wb", "frows", "side", "partials",
                     "per_point_smem", "gemm_smem", "blocks"), list(out)))


def wgmma_sizes(cfg: UDFConfig, n: int) -> dict:
    """The wgmma library's own reckoning of a launch at n points (card
    only; the CPU reckons wgmma_plan): wb, frows, side, partials,
    per_point_smem, gemm_smem, blocks."""
    out = (ctypes.c_longlong * 7)()
    if _wgmma_lib().emap_mlp_train_wgmma_sizes(
            kernel_layout(cfg).ctypes.data, n, out):
        raise ValueError("layout refused by the wgmma kernels")
    return dict(zip(("wb", "frows", "side", "partials", "per_point_smem",
                     "gemm_smem", "blocks"), list(out)))


def _launch_wgmma(x_T, w_pack, b_pack, ubar, gbar, cfg, n):
    """(wbar, bbar, scratch): the wgmma launch and the scratch it wrote."""
    lib = _wgmma_lib()
    plan = wgmma_plan(cfg, n)
    dev = x_T.device
    wbar = torch.empty_like(w_pack)
    bbar = torch.empty_like(b_pack)
    wb = torch.empty(plan["wb"], device=dev, dtype=torch.bfloat16)
    factors = torch.empty(plan["frows"] * n, device=dev, dtype=torch.bfloat16)
    side = torch.empty(plan["side"], device=dev, dtype=torch.float32)
    partials = torch.empty(plan["partials"], device=dev, dtype=torch.float32)
    err = lib.emap_mlp_train_wgmma(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), ubar.data_ptr(),
        gbar.data_ptr(), wbar.data_ptr(), bbar.data_ptr(), wb.data_ptr(),
        factors.data_ptr(), side.data_ptr(), partials.data_ptr(), n,
        kernel_layout(cfg).ctypes.data, float(cfg.scale), 1, 1,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_train_wgmma kernel launch failed: CUDA "
                           f"error {err}")
    rows, L = w_pack.shape[0], b_pack.shape[1]
    return wbar, bbar, {
        "wb": wb.view(WGMMA_FMAX, -1), "factors": factors.view(-1, n),
        "wpart": partials[: WGMMA_KS * w_pack.numel()].view(
            WGMMA_KS, rows, -1),
        "bpart": partials[WGMMA_KS * w_pack.numel():].view(-1, rows, L)}


def _launch_tf32(x_T, w_pack, b_pack, ubar, gbar, cfg, n, tiers):
    """(wbar, bbar, scratch): csrc/mlp_train_tf32.cu's launch at `tiers`
    and the scratch it wrote."""
    lib = _tf32_lib()
    plan = train_tf32_plan(cfg, n)
    dev = x_T.device
    wbar = torch.empty_like(w_pack)
    bbar = torch.empty_like(b_pack)
    pack = torch.empty(plan["pack"], device=dev, dtype=torch.float32)
    wb = torch.empty(plan["wb"], device=dev, dtype=torch.bfloat16)
    factors = torch.empty(plan["frows"] * n, device=dev,
                          dtype=plan["factor_dtype"])
    side = torch.empty(plan["side"], device=dev, dtype=torch.float32)
    partials = torch.empty(plan["partials"], device=dev, dtype=torch.float32)
    err = lib.emap_mlp_train_tf32(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), ubar.data_ptr(),
        gbar.data_ptr(), wbar.data_ptr(), bbar.data_ptr(), pack.data_ptr(),
        wb.data_ptr(), factors.data_ptr(), side.data_ptr(),
        partials.data_ptr(), n, kernel_layout(cfg).ctypes.data,
        float(cfg.scale), *tiers, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"mlp_train_tf32 kernel launch failed: CUDA "
                           f"error {err}")
    rows, L = w_pack.shape[0], b_pack.shape[1]
    return wbar, bbar, {
        "pack": pack.view(2 * WGMMA_FMAX, -1),
        "wb": wb.view(WGMMA_FMAX, -1) if plan["wb"] else None,
        "factors": factors.view(-1, n),
        "wpart": partials[: WGMMA_KS * w_pack.numel()].view(
            WGMMA_KS, rows, -1),
        "bpart": partials[WGMMA_KS * w_pack.numel():].view(-1, rows, L)}


def _launch_mma_sync(x_T, w_pack, b_pack, ubar, gbar, cfg, n, tiers):
    lib = _train_lib()
    layout = kernel_layout(cfg)
    rows, part = ctypes.c_longlong(), ctypes.c_longlong()
    if lib.emap_mlp_train_bwd_sizes(layout.ctypes.data, ctypes.byref(rows),
                                    ctypes.byref(part)):
        raise ValueError("layout refused by the kernel")
    dev = x_T.device
    wbar = torch.empty_like(w_pack)
    bbar = torch.empty_like(b_pack)
    scratch = torch.empty(rows.value * n, device=dev, dtype=torch.float32)
    partials = torch.empty(part.value, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.emap_mlp_train_bwd(
        x_T.data_ptr(), w_pack.data_ptr(), b_pack.data_ptr(), ubar.data_ptr(),
        gbar.data_ptr(), wbar.data_ptr(), bbar.data_ptr(), scratch.data_ptr(),
        partials.data_ptr(), n, layout.ctypes.data, float(cfg.scale), *tiers,
        stream)
    if err:
        raise RuntimeError(f"mlp_train kernel launch failed: CUDA error {err}")
    return wbar, bbar


def _operands(x_T, w_pack, b_pack, ubar, gbar, cfg):
    n = check_operands(cfg, (x_T, w_pack, b_pack, ubar, gbar))
    if ubar.shape != (1, n) or gbar.shape != (8, n):
        raise ValueError("cotangents must be ubar (1, N) and gbar (8, N)")
    return n, _pair_of(cfg)


def train_bwd(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """(wbar, bbar) for cotangents ubar (1, N), gbar (8, N) at raw points
    x_T (8, N), at cfg's primal and adjoint tiers. CPU tensors take
    train_bwd_plain; CUDA tensors launch the kernels: mlp_train_wgmma.cu's
    at the (bf16, bf16) pair, mlp_train_tf32.cu's at the others."""
    if not x_T.is_cuda:
        return train_bwd_plain(x_T, w_pack, b_pack, ubar, gbar, cfg)
    n, tiers = _operands(x_T, w_pack, b_pack, ubar, gbar, cfg)
    if tiers == (1, 1):
        out = _launch_wgmma(x_T, w_pack, b_pack, ubar, gbar, cfg, n)[:2]
    else:
        out = _launch_tf32(x_T, w_pack, b_pack, ubar, gbar, cfg, n,
                           tiers)[:2]
    train_bwd.launches += 1
    train_bwd.tier_launches[pair_name(*tiers)] += 1
    return out


train_bwd.launches = 0
train_bwd.tier_launches = {pair_name(p, a): 0 for p in (0, 1) for a in (0, 1)}


def train_bwd_wgmma_parts(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """One launch of the wgmma kernels on CUDA tensors at cfg (the bf16
    pair) with what each launch wrote: wbar, bbar and the scratch wb (the
    bf16 pack), factors (frows, N), wpart (KS, rmax, ldw) and bpart
    (blocks, rmax, L), to hold each launch against its plain version.
    Counted in no launch count; the training path never calls it."""
    n, tiers = _operands(x_T, w_pack, b_pack, ubar, gbar, cfg)
    if tiers != (1, 1):
        raise ValueError("the wgmma kernels run the (bf16, bf16) pair only")
    wbar, bbar, scratch = _launch_wgmma(x_T, w_pack, b_pack, ubar, gbar, cfg,
                                        n)
    return dict(scratch, wbar=wbar, bbar=bbar)


def train_bwd_tf32_parts(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """One launch of csrc/mlp_train_tf32.cu on CUDA tensors at cfg's pair
    (one tier 3xTF32) with what each launch wrote: wbar, bbar and the
    scratch pack (the 3xTF32 pack), wb (the bf16 pack, None without a bf16
    tier), factors (frows, N), wpart (KS, rmax, ldw) and bpart (blocks,
    rmax, L), to hold each launch against its plain version. Counted in no
    launch count; the training path never calls it."""
    n, tiers = _operands(x_T, w_pack, b_pack, ubar, gbar, cfg)
    if tiers == (1, 1):
        raise ValueError("the 3xTF32 kernels run the pairs with a 3xTF32 "
                         "tier")
    wbar, bbar, scratch = _launch_tf32(x_T, w_pack, b_pack, ubar, gbar, cfg,
                                       n, tiers)
    return dict(scratch, wbar=wbar, bbar=bbar)


def train_bwd_mma_sync(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """csrc/mlp_train.cu at cfg's pair, on CUDA tensors: the mma.sync design
    timed beside the wgmma kernels. Counted in no launch count; no path
    calls it."""
    n, tiers = _operands(x_T, w_pack, b_pack, ubar, gbar, cfg)
    return _launch_mma_sync(x_T, w_pack, b_pack, ubar, gbar, cfg, n, tiers)


def train_bwd_flops(cfg: UDFConfig) -> int:
    """FLOP a point of the backward's products (2 * in * out each): forward
    recompute, gradient chain (no lin0), ascend r_hat, descend u_hat (no
    lin0) and the two weight-gradient outer products."""
    shapes = [(i, o) for _, i, o in cfg.layer_shapes()]
    total = sum(i * o for i, o in shapes)
    first = shapes[0][0] * shapes[0][1]
    return 2 * (6 * total - 2 * first)


class TrainQuery(torch.autograd.Function):
    """(x_T (8, N), w_pack, b_pack) -> (udf (N,), grad (8, N)),
    differentiable w.r.t. the packed weights only."""

    @staticmethod
    def forward(ctx, x_T, w_pack, b_pack, cfg):
        # fp32 residuals, as emap_tpu/kernels/mlp_train.py's _train_query
        udf, grad = mlp_query.value_and_grad(x_T, w_pack, b_pack, cfg,
                                             f32_residuals=True)
        ctx.save_for_backward(x_T, w_pack, b_pack)
        ctx.cfg = cfg
        return udf, grad

    @staticmethod
    @once_differentiable
    def backward(ctx, g_udf, g_grad):
        x_T, w_pack, b_pack = ctx.saved_tensors
        n = x_T.shape[1]
        if g_udf is None:
            g_udf = x_T.new_zeros(n)
        if g_grad is None:
            g_grad = x_T.new_zeros(8, n)
        wbar, bbar = train_bwd(
            x_T, w_pack, b_pack, g_udf.reshape(1, n).contiguous(),
            g_grad.contiguous(), ctx.cfg)
        return None, wbar, bbar, None


def udf_train_value_and_gradient(params, pts, cfg: UDFConfig):
    """pts (N, 3) -> (udf (N,), grad (N, 3)), differentiable w.r.t.
    `params` through the spatial gradient (second order). The points are
    detached: their cotangent is zero by design."""
    mlp_query.check_kernel_cfg(cfg)
    pts = pts.detach()
    w_pack, b_pack = pack_weights(params, cfg, fuse_pe=True)
    n = pts.shape[0]
    n_pad = mlp_query.round_up(max(n, 1), POINT_TILE)
    x_T = pts.new_zeros(8, n_pad)
    x_T[:3, :n] = pts.T.to(torch.float32)
    udf, grad = TrainQuery.apply(x_T, w_pack.contiguous(), b_pack.contiguous(),
                                 cfg)
    return udf[:n], grad[:3, :n].T
