"""The Python side of #2's wgmma kernels (csrc/mlp_train_wgmma.cu), which
the CPU reaches: the bf16 weight pack their prologue writes, the factor
path (the per-point kernel stores the weight-gradient factors in bf16, the
GEMM contracts them), their shared-memory and register plan, and each
launch's FLOP and bytes. The kernels themselves run only on the card
(tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu.fields import udf as judf
from emap_tpu.kernels import mlp_query as jq
from emap_tpu.kernels import mlp_train as jt
from emap_tpu_torch.ckpt.convert import params_from_numpy
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq
from emap_tpu_torch.kernels import mlp_train as tt

TOY = dict(d_hidden=64, n_layers=8, multires=6)
CFGS = {"abc": {}, "replica": {"multires": 6}, "toy": TOY}
N = 256  # two 128-point tiles of the interpret-mode Pallas kernels


def net(cfg, seed=0):
    """Geometric init plus seeded noise, so no layer sits at its init
    pattern."""
    gen = torch.Generator().manual_seed(seed)
    params = tudf.init_udf_params(gen, cfg, device="cpu")
    return {k: {n: t + 0.05 * torch.randn(t.shape, generator=gen)
                for n, t in layer.items()} for k, layer in params.items()}


def points(n=N, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, n), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, n))
    ubar = rng.normal(size=(1, n)).astype(np.float32)
    gbar = np.zeros((8, n), np.float32)
    gbar[:3] = rng.normal(size=(3, n))
    return x, ubar, gbar


@pytest.mark.parametrize("name", sorted(CFGS))
def test_bf16_pack_round_trips(name):
    """Each layer's block of pack_weights_bf16 is that layer of
    unpack_weights rounded as tier_dot rounds it (.to(bfloat16)), at a
    64-aligned column; every other entry is zero."""
    cfg = tudf.UDFConfig(**CFGS[name])
    w, b = (t.detach() for t in tq.pack_weights(net(cfg), cfg))
    wb = tt.pack_weights_bf16(w, cfg)
    lay = tt.wgmma_layout(cfg)
    assert wb.dtype == torch.bfloat16
    assert wb.shape == (tt.WGMMA_FMAX, lay["ldwb"])
    seen = torch.zeros(wb.shape, dtype=torch.bool)
    for (wl, _), col in zip(tq.unpack_weights(w, b, cfg), lay["offb"]):
        o, i = wl.shape
        block = wb[:o, col: col + i]
        assert torch.equal(block.float(), tudf.round_bf16(wl))
        assert torch.equal(block, wl.to(torch.bfloat16))
        seen[:o, col: col + i] = True
        assert col % 64 == 0
    assert not bool(wb[~seen].float().any())


def test_bf16_pack_rounds_as_jax_astype():
    """pack_weights_bf16 of the JAX package's packed weights (fuse_pe)
    holds each layer's block exactly as jnp's astype(bfloat16) rounds it:
    the rounding of the JAX package's bf16 tier."""
    cfg = tudf.UDFConfig(**TOY)
    jcfg = judf.UDFConfig(**TOY)
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: jnp.asarray((np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32)),
        judf.init_udf_params(jax.random.key(0), jcfg))
    wj, _ = jq.pack_weights(jp, jcfg, fuse_pe=True)
    wj16 = np.asarray(wj.astype(jnp.bfloat16).astype(jnp.float32))
    wb = tt.pack_weights_bf16(torch.as_tensor(np.array(wj)),
                              cfg).float().numpy()
    lay = tt.wgmma_layout(cfg)
    off = 0
    for (i, o), col in zip(lay["dims"], lay["offb"]):
        np.testing.assert_array_equal(wb[:o, col: col + i],
                                      wj16[:o, off: off + i])
        off += i


@pytest.mark.parametrize("udf_type", ["abs", "square"])
@pytest.mark.parametrize("pair", [("default", ""), ("high", "default")])
def test_bf16_factors_lose_nothing(pair, udf_type):
    """At a bf16 adjoint tier the factors stored as bf16
    (train_bwd_factors) and contracted in fp32 (wbar_from_factors) give the
    W-bar of train_bwd_plain bit for bit, and the b-bar summed from the
    fp32 z-hat is unchanged: the rounding the kernel's stores apply is the
    one tier_dot applies to the same operands."""
    cfg = tudf.UDFConfig(udf_type=udf_type, precision=pair[0],
                         bwd_precision=pair[1], **TOY)
    w, b = (t.detach() for t in tq.pack_weights(net(cfg), cfg))
    x, ubar, gbar = (torch.as_tensor(a) for a in points())
    wbar, bbar = tt.train_bwd_plain(x, w, b, ubar, gbar, cfg)
    F, bbar_f = tt.train_bwd_factors(x, w, b, ubar, gbar, cfg)
    assert F.dtype == torch.bfloat16
    assert F.shape == (tt.wgmma_layout(cfg)["frows"], N)
    assert torch.equal(tt.wbar_from_factors(F, cfg), wbar)
    assert torch.equal(bbar_f, bbar)


@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_factor_path_matches_pallas(udf_type):
    """The factor path at the (bf16, bf16) pair against the JAX package's
    _pallas_train_bwd at "default" in interpret mode, within
    tests/test_torch_precision.py's BWD_RTOL (8e-3 of each output's
    largest entry; bf16 flips of the same operands)."""
    jcfg = judf.UDFConfig(precision="default", udf_type=udf_type, **TOY)
    cfg = tudf.UDFConfig(precision="default", udf_type=udf_type, **TOY)
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32),
        judf.init_udf_params(jax.random.key(0), jcfg))
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, cfg, device="cpu")["udf"]
    w, b = (t.detach() for t in tq.pack_weights(tp, cfg))
    x, ubar, gbar = points()
    F, bbar = tt.train_bwd_factors(torch.as_tensor(x), w, b,
                                   torch.as_tensor(ubar),
                                   torch.as_tensor(gbar), cfg)
    wbar = tt.wbar_from_factors(F, cfg)
    wj, bj = jq.pack_weights(jax.tree.map(jnp.asarray, jp), jcfg, fuse_pe=True)
    wbj, bbj = jt._pallas_train_bwd(jnp.asarray(x), wj, bj, jnp.asarray(ubar),
                                    jnp.asarray(gbar), jcfg, 128, True,
                                    fuse_pe=True)

    def max_rel(a, c):
        a, c = np.asarray(a, np.float64), np.asarray(c, np.float64)
        return float(np.abs(a - c).max() / (np.abs(c).max() + 1e-30))

    assert max_rel(wbar.numpy(), wbj) < 8e-3
    assert max_rel(bbar.numpy(), bbj) < 8e-3


@pytest.mark.parametrize("name", sorted(CFGS))
def test_wgmma_plan_fits(name):
    """The per-point kernel's shared memory (a 4-stage weight ring, two
    warpgroups' two 256-row activation tiles, the bias sums) and the
    GEMM's (a 4-stage factor ring) fit the H100's 232,448 bytes a block at
    every width the kernels take; a consumer's accumulators are 128 fp32
    registers of its 232."""
    cfg = tudf.UDFConfig(**CFGS[name])
    plan = tt.wgmma_plan(cfg, 116_736)
    assert plan["smem"] == {"per_point": 65_536 + 131_072 + 8_192 + 2_560
                            + 64 + 1_024,
                            "gemm": 131_072 + 64 + 1_024}
    assert max(plan["smem"].values()) <= tt.SMEM_LIMIT
    assert plan["registers"]["accumulators"] <= plan["registers"]["consumer"]
    assert 128 * plan["registers"]["producer"] + 256 * plan["registers"][
        "consumer"] <= 65_536
    assert plan["blocks"] == 912
    lay = tt.wgmma_layout(cfg)
    assert plan["frows"] == lay["frows"] == sum(
        2 * (k + o) for k, o in zip(lay["kpad"], lay["opad"]))


def test_wgmma_layout_at_abc_and_replica_width():
    """ABC (d0p 64) and Replica (d0p 40) share the kernels' padded layout:
    layer 0's input padded to 64, lin3's 193 / 217 outputs and the head's
    one to whole 64-row boxes."""
    for cfg, out3 in ((tudf.UDFConfig(), 193),
                      (tudf.UDFConfig(multires=6), 217)):
        lay = tt.wgmma_layout(cfg)
        assert lay["dims"][3] == (256, out3)
        assert lay["kpad"] == [64] + [256] * 8
        assert lay["opad"] == [256] * 8 + [64]
        assert lay["offb"] == [0] + [64 + 256 * k for k in range(8)]
        assert (lay["ldwb"], lay["frows"]) == (2_112, 8_448)


@pytest.mark.parametrize("width", [320, 512])
def test_wgmma_plan_refuses_what_does_not_fit(width):
    """A layer wider than the kernels' 256-row tiles is refused before any
    launch, on every device."""
    cfg = tudf.UDFConfig(d_hidden=width)
    with pytest.raises(ValueError):
        tt.wgmma_plan(cfg, 4096)


def test_launch_costs_match_a_hand_count_at_abc_width():
    """The FLOP and bytes of each launch at ABC width and the step's
    116,736 points, counted by hand. Layers (unpadded): lin0 63 x 256,
    lin1-2 and lin4-7 256 x 256, lin3 256 x 193 (the skip), lin8 256 x 1:
    sum(in * out) = 459,008, lin0's 16,128."""
    n = 116_736
    costs = tt.train_bwd_launch_costs(tudf.UDFConfig(), n)
    total, first = 459_008, 16_128
    # forward, gradient chain (no lin0), ascend, descend (no lin0)
    assert costs["per_point"]["flops"] == 2 * (4 * total - 2 * first) * n
    # both weight-gradient outer products
    assert costs["gemm"]["flops"] == 4 * total * n
    assert (costs["per_point"]["flops"] + costs["gemm"]["flops"]
            == tt.train_bwd_flops(tudf.UDFConfig()) * n == 5_443_584 * n)
    w_f32, wb_bf16, b_f32 = 256 * 2_112 * 4, 256 * 2_112 * 2, 256 * 9 * 4
    factors = 8_448 * n * 2  # U, Q-hat, R, Z-hat rows, bf16
    bpart = 912 * 256 * 9 * 4  # a bias partial a 128-point block
    wpart = 4 * 256 * 2_112 * 4  # a W-bar partial a point range
    assert costs["pack"] == {"flops": 0, "bytes": w_f32 + wb_bf16}
    assert costs["per_point"]["bytes"] == (
        (8 + 1 + 8) * 4 * n + wb_bf16 + b_f32 + factors + bpart)
    # sigmoid and carry / s-hat: 8 passes of 256 fp32 over 8 hidden layers
    assert costs["per_point"]["side_bytes"] == 8 * 4 * 256 * 8 * n
    assert costs["gemm"]["bytes"] == factors + wpart
    assert costs["reduce"] == {"flops": 0,
                               "bytes": wpart + bpart + w_f32 + b_f32}


def test_train_bwd_routes_cpu_tensors_to_the_plain_version():
    """On the CPU the wrapper takes train_bwd_plain at every pair, the
    bf16 one included, and counts no launch."""
    cfg = tudf.UDFConfig(precision="default", **TOY)
    w, b = (t.detach() for t in tq.pack_weights(net(cfg), cfg))
    x, ubar, gbar = (torch.as_tensor(a) for a in points(128))
    before = dict(tt.train_bwd.tier_launches)
    got = tt.train_bwd(x, w, b, ubar, gbar, cfg)
    want = tt.train_bwd_plain(x, w, b, ubar, gbar, cfg)
    assert all(torch.equal(g, c) for g, c in zip(got, want))
    assert tt.train_bwd.tier_launches == before
