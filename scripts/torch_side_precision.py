#!/usr/bin/env python3
"""What narrower side arrays would cost #2's wgmma kernels in accuracy, on
the CPU.

    python3 scripts/torch_side_precision.py

csrc/mlp_train_wgmma.cu keeps sigmoid(100 z_l) and carry_{l+1} / s-hat_l
of every hidden layer in fp32 device scratch between its chains. This
script runs the backward's plain math at the (bf16, bf16) pair with those
values passed through a narrower format where the kernel would store
them (fp16 or bf16), at ABC and Replica width on 8,192 points, and prints
each variant's max and mean error per W-bar / b-bar block against the
unchanged plain version, beside its mean error against the fp32 plain
version (the separation the bf16 gates ask for is 2x; the kernel's own
error at ABC width is a max of 4.2e-3 and a mean of 7.2e-4, PERF.md).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from emap_tpu_torch.fields import udf as tudf  # noqa: E402
from emap_tpu_torch.fields.udf import adjoint_tier, softplus100  # noqa: E402
from emap_tpu_torch.kernels import mlp_query as tq  # noqa: E402
from emap_tpu_torch.kernels import mlp_train as tt  # noqa: E402


def backward(x, w_pack, b_pack, ubar, gbar, cfg, keep_s, keep_c):
    """mlp_train._bwd_factors' chains and contraction with the sigmoids
    read back through keep_s and the carries and s-hats through keep_c."""
    tp, ta = cfg.precision, adjoint_tier(cfg)
    layers = tq.unpack_weights(w_pack, b_pack, cfg)
    L, d0 = len(layers), cfg.dims[0]
    zs, us, h = [], [], x
    for l, (w, b) in enumerate(layers):
        if l in cfg.skip_in:
            h = torch.cat([h, x[:d0]], 0) * tq.INV_SQRT2
        us.append(h)
        z = tq.tier_dot(w, h, tp) + b[:, None]
        if l < L - 1:
            zs.append(z)
            h = softplus100(z)
        else:
            y0 = z[:1]
    dy = tq.dy_of_y0(y0, cfg)
    ss = [keep_s(torch.sigmoid(100.0 * z)) for z in zs]
    carries, r = [None] * L, dy
    for l in reversed(range(1, L)):
        q = tq.tier_dot(layers[l][0].T, r, tp)
        carry = q[:-d0] * tq.INV_SQRT2 if l in cfg.skip_in else q
        r = carry * ss[l - 1]
        carries[l] = keep_c(carry)
    rs = [dy if l == L - 1 else carries[l + 1] * ss[l] for l in range(L)]
    q_hats, s_hat, carryhat = [None] * L, [None] * (L - 1), None
    for l in range(L):
        q_hat = gbar if l == 0 else (torch.cat(
            [carryhat * tq.INV_SQRT2, gbar[:d0] * tq.INV_SQRT2], 0)
            if l in cfg.skip_in else carryhat)
        q_hats[l] = q_hat
        r_hat = tq.tier_dot(layers[l][0], q_hat, ta)
        if l < L - 1:
            s_hat[l] = keep_c(r_hat * carries[l + 1])
            carryhat = r_hat * ss[l]
        else:
            r_hat_last = r_hat
    z_hats, b_contrib, a_hat = [None] * L, [None] * L, None
    for l in reversed(range(L)):
        if l == L - 1:
            z_hat = ubar * dy
            if cfg.udf_type == "square":
                z_hat = z_hat + r_hat_last * (2.0 / cfg.scale)
        else:
            s = ss[l]
            z_hat = a_hat * s + s_hat[l] * (100.0 * s * (1.0 - s))
        z_hats[l] = z_hat
        b_contrib[l] = z_hat.sum(1, keepdim=True)
        if l == 0:
            break
        u_hat = tq.tier_dot(layers[l][0].T, z_hat, ta)
        a_hat = u_hat[:-d0] * tq.INV_SQRT2 if l in cfg.skip_in else u_hat
    w_contrib = [tq.tier_dot(rs[l], q_hats[l].T, ta)
                 + tq.tier_dot(z_hats[l], us[l].T, ta) for l in range(L)]
    return tt._packed_grads(w_contrib, b_contrib, w_pack.shape[0])


def main() -> int:
    def same(t):
        return t

    def fp16(t):
        return t.half().float()

    def bf16(t):
        return t.bfloat16().float()

    variants = (("fp16 sigmoids", fp16, same), ("fp16 carries", same, fp16),
                ("fp16 both", fp16, fp16), ("bf16 sigmoids", bf16, same),
                ("bf16 carries", same, bf16))
    for name, base in (("abc", tudf.UDFConfig()),
                       ("replica", tudf.UDFConfig(multires=6))):
        cfg = dataclasses.replace(base, precision="default")
        gen = torch.Generator().manual_seed(0)
        params = tudf.init_udf_params(gen, cfg, device="cpu")
        params = {k: {m: t + 0.05 * torch.randn(t.shape, generator=gen)
                      for m, t in v.items()} for k, v in params.items()}
        w, b = (t.detach() for t in tq.pack_weights(params, cfg))
        n = 8192
        x_T = torch.zeros(8, n)
        x_T[:3] = torch.rand(3, n, generator=gen) * 2 - 1
        ubar = torch.randn(1, n, generator=gen)
        g_T = torch.zeros(8, n)
        g_T[:3] = torch.randn(3, n, generator=gen)
        x, uf = tq.encode_fused(x_T, cfg)
        gbar = tq.pe_jacT_fused(uf, g_T, cfg)
        want = tt._train_bwd_math(x, w, b, ubar, gbar, cfg)
        assert all(torch.equal(a, c) for a, c in zip(
            backward(x, w, b, ubar, gbar, cfg, same, same), want))
        want32 = tt._train_bwd_math(x, w, b, ubar, gbar,
                                    dataclasses.replace(cfg, precision="high"))

        def blocks(out):
            return [t for layer in tq.unpack_weights(*out, cfg)
                    for t in layer]

        def worst(got, ref, stat):
            return max(float(stat((a - c).abs()) / (c.abs().max() + 1e-30))
                       for a, c in zip(blocks(got), blocks(ref)))

        for label, keep_s, keep_c in variants:
            got = backward(x, w, b, ubar, gbar, cfg, keep_s, keep_c)
            mean = worst(got, want, torch.mean)
            mean32 = worst(got, want32, torch.mean)
            print(f"{name} {label}: max rel err {worst(got, want, torch.max):.3e}"
                  f", mean {mean:.3e}; against fp32 mean {mean32:.3e} "
                  f"(separation {mean32 / mean:.1f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
