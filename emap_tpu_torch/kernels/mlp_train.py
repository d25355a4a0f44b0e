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
  tensors launch csrc/mlp_train.cu (replaces
  emap_tpu/kernels/mlp_train.py::_pallas_train_bwd) or raise.
  `train_bwd.launches` counts the kernel launches, `train_bwd.tier_launches`
  the same by (primal, adjoint) tier pair (`pair_name`).
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
    TIER_NAMES,
    check_operands,
    dy_of_y0,
    encode_fused,
    kernel_layout,
    kernel_tier,
    pack_weights,
    pe_jacT_fused,
    tier_dot,
    unpack_weights,
)


def pair_name(primal: int, adjoint: int) -> str:
    """The name of a (primal, adjoint) pair of kernel tier codes:
    "bf16", "3xtf32", or "3xtf32+bf16" for a 3xTF32 primal and a bf16
    adjoint."""
    if primal == adjoint:
        return TIER_NAMES[primal]
    return f"{TIER_NAMES[primal]}+{TIER_NAMES[adjoint]}"


def _train_bwd_math(x, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """x (d0_pad, T) encoded, ubar (1, T), gbar (d0_pad, T) encoded-space
    -> (wbar (row_max, sum_in), bbar (row_max, L)). Primal products at
    cfg.precision, adjoint products at adjoint_tier(cfg)."""
    tp, ta = cfg.precision, adjoint_tier(cfg)
    layers = unpack_weights(w_pack, b_pack, cfg)
    L = len(layers)
    d0 = cfg.dims[0]
    row_max = w_pack.shape[0]

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

    w_contrib = [None] * L
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
        w_contrib[l] = tier_dot(r_of(l), q_hat.T, ta)
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
        w_contrib[l] = w_contrib[l] + tier_dot(z_hat, us[l].T, ta)
        b_contrib[l] = torch.sum(z_hat, dim=1, keepdim=True)
        if l == 0:
            break
        u_hat = tier_dot(W(l).T, z_hat, ta)
        a_hat = u_hat[:-d0] * INV_SQRT2 if l in cfg.skip_in else u_hat

    def pad(a):
        return torch.nn.functional.pad(a, (0, 0, 0, row_max - a.shape[0]))

    return (torch.cat([pad(w) for w in w_contrib], dim=1),
            torch.cat([pad(b) for b in b_contrib], dim=1))


def train_bwd_plain(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """Plain PyTorch version of the backward: x_T (8, N) raw points,
    ubar (1, N), gbar (8, N) -> (wbar, bbar) packed like w_pack/b_pack."""
    x, uf = encode_fused(x_T, cfg)
    gb = pe_jacT_fused(uf, gbar, cfg)
    return _train_bwd_math(x, w_pack, b_pack, ubar, gb, cfg)


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


def train_bwd(x_T, w_pack, b_pack, ubar, gbar, cfg: UDFConfig):
    """(wbar, bbar) for cotangents ubar (1, N), gbar (8, N) at raw points
    x_T (8, N), at cfg's primal and adjoint tiers. CPU tensors take
    train_bwd_plain; CUDA tensors launch the kernel."""
    if not x_T.is_cuda:
        return train_bwd_plain(x_T, w_pack, b_pack, ubar, gbar, cfg)
    n = check_operands(cfg, (x_T, w_pack, b_pack, ubar, gbar))
    tiers = kernel_tier(cfg.precision), kernel_tier(adjoint_tier(cfg))
    if ubar.shape != (1, n) or gbar.shape != (8, n):
        raise ValueError("cotangents must be ubar (1, N) and gbar (8, N)")
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
    train_bwd.launches += 1
    train_bwd.tier_launches[pair_name(*tiers)] += 1
    return wbar, bbar


train_bwd.launches = 0
train_bwd.tier_launches = {pair_name(p, a): 0 for p in (0, 1) for a in (0, 1)}


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
        udf, grad = mlp_query.value_and_grad(x_T, w_pack, b_pack, cfg)
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
