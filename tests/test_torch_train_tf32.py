"""The Python side of #2's kernels at the pairs with a 3xTF32 tier
(csrc/mlp_train_tf32.cu), which the CPU reaches: their shared-memory and
scratch plan, each launch's FLOP and bytes, and the plain versions of the
factor path (the per-point kernel stores the weight-gradient factors in
fp32 at a 3xTF32 adjoint and in bf16 at a bf16 one; the 3xTF32 GEMM
contracts fp32 factors in 32-point chunks, the bf16 one bf16 factors),
held against train_bwd_plain and the JAX package's Pallas kernel in
interpret mode. The kernels themselves run only on the card
(tests/test_torch_cuda.py, `-k train_tf32`)."""

import dataclasses

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
# the (precision, bwd_precision) of each pair the library runs, by the
# wrappers' tier name
PAIRS = {"3xtf32": ("high", ""), "3xtf32+bf16": ("high", "default"),
         "bf16+3xtf32": ("default", "high")}
N = 256  # two 128-point tiles of the interpret-mode Pallas kernels
# The 3xTF32 pair against fp32: the card's gate for the 3xTF32 kernels,
# 1e-4 of each block's largest entry; the GEMM's split drops lo*lo and
# rounds lo (~2^-22 a product), and the JAX package's "high" is a 3-pass
# bf16 emulation of fp32, each far below it.
KERNEL_RTOL = 1e-4
# A bf16 adjoint against the Pallas kernel at the same pair:
# tests/test_torch_precision.py's BWD_RTOL (bf16 flips of the same
# operands).
BWD_RTOL = 8e-3


def cfg_at(pair, udf_type="abs", **width):
    precision, bwd = PAIRS[pair]
    return tudf.UDFConfig(precision=precision, bwd_precision=bwd,
                          udf_type=udf_type, **width)


def nets(pair, udf_type, width):
    """(JAX params, port packed weights, port cfg, JAX cfg) of one net with
    seeded noise on every weight."""
    precision, bwd = PAIRS[pair]
    jcfg = judf.UDFConfig(precision=precision, bwd_precision=bwd,
                          udf_type=udf_type, **width)
    cfg = cfg_at(pair, udf_type, **width)
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32),
        judf.init_udf_params(jax.random.key(0), jcfg))
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, cfg, device="cpu")["udf"]
    w, b = (t.detach() for t in tq.pack_weights(tp, cfg))
    return jp, (w, b), cfg, jcfg


def points(n=N, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, n), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, n))
    ubar = rng.normal(size=(1, n)).astype(np.float32)
    gbar = np.zeros((8, n), np.float32)
    gbar[:3] = rng.normal(size=(3, n))
    return x, ubar, gbar


def pallas(jp, jcfg, x, ubar, gbar):
    wj, bj = jq.pack_weights(jax.tree.map(jnp.asarray, jp), jcfg,
                             fuse_pe=True)
    return tuple(torch.as_tensor(np.array(r)) for r in jt._pallas_train_bwd(
        jnp.asarray(x), wj, bj, jnp.asarray(ubar), jnp.asarray(gbar), jcfg,
        128, True, fuse_pe=True))


def max_rel(a, c) -> float:
    a, c = np.asarray(a, np.float64), np.asarray(c, np.float64)
    return float(np.abs(a - c).max() / (np.abs(c).max() + 1e-30))


def worst_block(got, want, cfg) -> float:
    """The largest max rel error over the layers' W-bar and b-bar blocks,
    each against its own largest entry."""
    return max(max_rel(g, w)
               for gl, wl in zip(tq.unpack_weights(*got, cfg),
                                 tq.unpack_weights(*want, cfg))
               for g, w in zip(gl, wl))


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_train_tf32_plan_fits(name, pair):
    """The per-point kernel's shared memory (a 4-stage ring of 32 KB
    entries, one 64-point fp32 tile, the bias sums, the head's vectors) and
    the GEMM's (at a 3xTF32 adjoint a 4-stage ring of both fp32 factors'
    32-point chunks and the B rows' lo half; at a bf16 one
    mlp_train_gemm.cuh's) fit the H100's 232,448 bytes a block at every
    width the kernels take; the scratch at the step's 116,736 points."""
    cfg = cfg_at(pair, **CFGS[name])
    plan = tt.train_tf32_plan(cfg, 116_736)
    adjoint_bf16 = pair == "3xtf32+bf16"
    assert plan["smem"] == {
        "per_point": 131_072 + 65_536 + 4_096 + 1_792 + 64 + 1_024,
        "gemm": (131_072 + 64 + 1_024 if adjoint_bf16
                 else 131_072 + 65_536 + 96 + 1_024)}
    assert max(plan["smem"].values()) <= tt.SMEM_LIMIT
    regs = plan["registers"]
    assert regs["accumulators"] + regs["a_fragments"] <= 168
    assert 128 * regs["producer"] + 256 * regs["consumer"] <= 65_536
    assert plan["blocks"] == 1_824
    lay = tt.wgmma_layout(cfg)
    assert plan["frows"] == lay["frows"]
    assert plan["factor_dtype"] == (torch.bfloat16 if adjoint_bf16
                                    else torch.float32)
    assert plan["pack"] == 512 * tq.query_tf32_layout(cfg)["ldp"]
    assert plan["wb"] == (0 if pair == "3xtf32" else 256 * lay["ldwb"])
    L = len(lay["dims"])
    assert plan["side"] == 1_824 * (L - 1) * 2 * 256 * 64


@pytest.mark.parametrize("width", [320, 512])
def test_train_tf32_plan_refuses_what_does_not_fit(width):
    """A layer wider than the kernels' 256-feature tile is refused before
    any launch, on every device."""
    with pytest.raises(ValueError):
        tt.train_tf32_plan(cfg_at("3xtf32", d_hidden=width), 4096)


def test_train_tf32_plan_refuses_the_bf16_pair():
    """The (bf16, bf16) pair is mlp_train_wgmma.cu's, not this library's."""
    with pytest.raises(ValueError):
        tt.train_tf32_plan(tudf.UDFConfig(precision="default"), 4096)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_train_tf32_launch_costs_match_a_hand_count(pair):
    """The FLOP and bytes of each launch at ABC width and the step's
    116,736 points, counted by hand (tests/test_torch_wgmma.py's layers:
    sum(in * out) = 459,008, lin0's 16,128): 421.1 GFLOP of per-point
    products, half of them at each tier, and 214.3 GFLOP of GEMM."""
    n = 116_736
    cfg = cfg_at(pair)
    costs = tt.train_tf32_launch_costs(cfg, n)
    total, first = 459_008, 16_128
    assert costs["per_point"]["flops"] == 421_131_190_272 == 2 * (
        4 * total - 2 * first) * n
    assert costs["per_point"]["tier_flops"] == (210_565_595_136,) * 2
    assert costs["gemm"]["flops"] == 214_331_031_552 == 4 * total * n
    w_f32, b_f32 = 256 * 2_112 * 4, 256 * 9 * 4
    # forward blocks: lin0's 64 columns, 7 x 256; transposed: 7 x 256, lin3's
    # 193 outputs in 224
    pack = 512 * (64 + 7 * 256 + 7 * 256 + 224) * 4
    wb = 256 * 2_112 * 2 if pair != "3xtf32" else 0
    factors = 8_448 * n * (2 if pair == "3xtf32+bf16" else 4)
    bpart = 1_824 * 256 * 9 * 4  # a bias partial a 64-point block
    wpart = 4 * 256 * 2_112 * 4  # a W-bar partial a point range
    assert costs["pack"] == {"flops": 0, "bytes": w_f32 + pack}
    assert costs["per_point"]["bytes"] == (
        (8 + 1 + 8) * 4 * n + pack + wb + b_f32 + factors + bpart)
    # sigmoid, carry / s-hat: 8 passes over the live 8-feature groups of
    # 7 hidden layers of 256 and lin3's 193 (200)
    assert costs["per_point"]["side_bytes"] == 8 * 4 * (7 * 256 + 200) * n
    assert costs["gemm"]["bytes"] == factors + wpart
    assert costs["reduce"] == {"flops": 0,
                               "bytes": wpart + bpart + w_f32 + b_f32}
    assert ("pack_bf16" in costs) == (pair != "3xtf32")
    if wb:
        assert costs["pack_bf16"] == {"flops": 0, "bytes": w_f32 + wb}


@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_fp32_factors_lose_nothing(udf_type):
    """At a 3xTF32 adjoint the factors are stored in fp32
    (train_bwd_factors): contracted in fp32 (wbar_from_factors) they give
    train_bwd_plain's W-bar bit for bit, and the b-bar summed from z-hat is
    unchanged."""
    _, (w, b), cfg, _ = nets("3xtf32", udf_type, TOY)
    x, ubar, gbar = (torch.as_tensor(a) for a in points())
    wbar, bbar = tt.train_bwd_plain(x, w, b, ubar, gbar, cfg)
    F, bbar_f = tt.train_bwd_factors(x, w, b, ubar, gbar, cfg)
    assert F.dtype == torch.float32
    assert F.shape == (tt.wgmma_layout(cfg)["frows"], N)
    assert torch.equal(tt.wbar_from_factors(F, cfg), wbar)
    assert torch.equal(bbar_f, bbar)


@pytest.mark.parametrize("udf_type", ["abs", "square"])
@pytest.mark.parametrize("name", ["abc", "toy"])
def test_tf32_factor_path_matches_plain_and_pallas(name, udf_type):
    """The 3xTF32 pair's factor path, the fp32 factors through the 3xTF32
    GEMM's plain version (wbar_tf32_from_factors: 32-point chunks split
    into hi and lo, promoted a chunk, the KS ranges added in order), against
    train_bwd_plain and the Pallas kernel at fp32 ("highest") in interpret
    mode, KERNEL_RTOL a block, as tests/test_torch_tf32.py holds the
    3xTF32 design (the JAX package's "high" is a 3-pass bf16 emulation of
    fp32, whose worst block here lies 1.8e-4 from fp32); and the GEMM's
    emulation did run (it differs from the fp32 contraction)."""
    jp, (w, b), cfg, jcfg = nets("3xtf32", udf_type, CFGS[name])
    x, ubar, gbar = points()
    args = (torch.as_tensor(x), w, b, torch.as_tensor(ubar),
            torch.as_tensor(gbar), cfg)
    F, bbar = tt.train_bwd_factors(*args)
    got = (tt.wbar_tf32_from_factors(F, cfg), bbar)
    plain = tt.train_bwd_plain(*args)
    assert not torch.equal(got[0], plain[0])
    assert worst_block(got, plain, cfg) < KERNEL_RTOL
    fp32 = dataclasses.replace(jcfg, precision="highest")
    assert worst_block(got, pallas(jp, fp32, x, ubar, gbar),
                       cfg) < KERNEL_RTOL


@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_mixed_factor_path_matches_pallas(udf_type):
    """The mixed pair's factor path: the bf16 factors (train_bwd_factors)
    through the bf16 GEMM's plain version (wbar_from_factors) against the
    Pallas kernel at ("high", "default") in interpret mode, within
    BWD_RTOL of each output's largest entry, and bit for bit against
    train_bwd_plain at that pair."""
    jp, (w, b), cfg, jcfg = nets("3xtf32+bf16", udf_type, TOY)
    x, ubar, gbar = points()
    args = (torch.as_tensor(x), w, b, torch.as_tensor(ubar),
            torch.as_tensor(gbar), cfg)
    F, bbar = tt.train_bwd_factors(*args)
    assert F.dtype == torch.bfloat16
    wbar = tt.wbar_from_factors(F, cfg)
    wbj, bbj = pallas(jp, jcfg, x, ubar, gbar)
    assert max_rel(wbar, wbj) < BWD_RTOL
    assert max_rel(bbar, bbj) < BWD_RTOL
    want = tt.train_bwd_plain(*args)
    assert torch.equal(wbar, want[0]) and torch.equal(bbar, want[1])


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_train_bwd_routes_cpu_tensors_to_the_plain_version(pair):
    """On the CPU the wrapper takes train_bwd_plain at each pair with a
    3xTF32 tier and counts no launch."""
    _, (w, b), cfg, _ = nets(pair, "abs", TOY)
    x, ubar, gbar = (torch.as_tensor(a) for a in points(128))
    before = dict(tt.train_bwd.tier_launches)
    got = tt.train_bwd(x, w, b, ubar, gbar, cfg)
    want = tt.train_bwd_plain(x, w, b, ubar, gbar, cfg)
    assert all(torch.equal(g, c) for g, c in zip(got, want))
    assert tt.train_bwd.tier_launches == before
    assert tt.pair_name(*tt._pair_of(cfg)) == pair


def test_gemm_emulation_reads_only_live_rows():
    """wbar_tf32_from_factors reads each layer's live factor rows alone:
    padding rows of any value change nothing (the kernels leave them
    unwritten)."""
    _, (w, b), cfg, _ = nets("3xtf32", "abs", TOY)
    x, ubar, gbar = (torch.as_tensor(a) for a in points())
    F, _ = tt.train_bwd_factors(x, w, b, ubar, gbar, cfg)
    lay = tt.wgmma_layout(cfg)
    noisy = F.clone()
    for l, (i, o) in enumerate(lay["dims"]):
        for name, size, pad in (("U", i, lay["kpad"][l]),
                                ("Q", i, lay["kpad"][l]),
                                ("R", o, lay["opad"][l]),
                                ("Z", o, lay["opad"][l])):
            row = lay["rows"][name][l]
            noisy[row + size: row + pad] = float("nan")
    assert torch.equal(tt.wbar_tf32_from_factors(noisy, cfg),
                       tt.wbar_tf32_from_factors(F, cfg))
