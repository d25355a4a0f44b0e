"""The Python side of #1a's wgmma kernels (csrc/mlp_query_wgmma.cu), which
the CPU reaches: the launch plan (shared memory, registers, scratch), the
FLOP and bytes of each launch, the wrapper's route for CPU tensors, and the
plain version the card holds the kernels against, itself held against the
JAX package's Pallas kernel at "default" on a ragged N. The kernels run
only on the card (tests/test_torch_cuda.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu.fields import udf as judf
from emap_tpu.kernels import mlp_query as jq
from emap_tpu_torch.ckpt.convert import params_from_numpy
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq

TOY = dict(d_hidden=64, n_layers=8, multires=6)
CFGS = {"abc": {}, "replica": {"multires": 6}, "toy": TOY}
N_STEP = 116_736  # the training step's points: 1,024 rays x 114 samples


@pytest.mark.parametrize("name", sorted(CFGS))
def test_query_wgmma_plan_fits(name):
    """A block's shared memory (a 4-stage weight ring, two warpgroups' two
    256-row activation tiles, their 64 x 64 fp32 d udf / d x-tilde blocks,
    the head's sums) fits the H100's 232,448 bytes at ABC width (d0p 64),
    Replica's (d0p 40) and the toy net's; a consumer's accumulators are 128
    fp32 registers of its 232; the scratch is the bf16 pack and 256 fp32
    sigmoids a hidden layer a point."""
    cfg = tudf.UDFConfig(**CFGS[name])
    plan = tq.query_wgmma_plan(cfg, N_STEP)
    assert plan["smem"] == (65_536 + 131_072 + 32_768 + 1_536 + 64
                            + 1_024) == 232_000
    assert plan["smem"] <= tq.SMEM_LIMIT
    assert plan["registers"]["accumulators"] <= plan["registers"]["consumer"]
    assert 128 * plan["registers"]["producer"] + 256 * plan["registers"][
        "consumer"] <= 65_536
    assert plan["blocks"] == 912
    lay = tq.wgmma_layout(cfg)
    assert plan["wb"] == 256 * lay["ldwb"]
    hidden = len(lay["dims"]) - 1
    assert plan["side"] == 2 * 912 * hidden * 256 * 64


@pytest.mark.parametrize("over", [{"d_hidden": 320}, {"d_hidden": 512},
                                  {"multires": 11}])
def test_query_wgmma_plan_refuses_what_does_not_fit(over):
    """A layer wider than the 256-row tiles, or an encoded input wider than
    the 64-row d udf / d x-tilde block (multires 11: d0 69, padded to 72),
    is refused before any launch, on every device."""
    with pytest.raises(ValueError):
        tq.query_wgmma_plan(tudf.UDFConfig(**over), 4096)


def test_query_wgmma_launch_costs_match_a_hand_count_at_abc_width():
    """The FLOP and bytes of each launch at ABC width and the step's
    116,736 points, counted by hand. Layers (unpadded): lin0 63 x 256,
    lin1-2 and lin4-7 256 x 256, lin3 256 x 193 (the skip), lin8 256 x 1:
    sum(in * out) = 459,008. The side arrays are the sigmoids of the eight
    hidden layers, written once and read once in fp32; of lin3's 193
    outputs the kernel moves the 25 live 8-feature groups, 200 rows."""
    n = N_STEP
    cfg = tudf.UDFConfig()
    costs = tq.query_wgmma_launch_costs(cfg, n)
    total = 459_008
    # forward and reverse, each 2 * sum(in * out) a point
    assert costs["query"]["flops"] == 2 * total * n + 2 * total * n
    assert costs["query"]["flops"] == tq.query_flops(cfg) * n
    w_f32, wb_bf16, b_f32 = 256 * 2_112 * 4, 256 * 2_112 * 2, 256 * 9 * 4
    head_row = 256 * 4
    assert costs["pack"] == {"flops": 0, "bytes": w_f32 + wb_bf16}
    # points (8, n) in, udf and grad (8, n) out
    assert costs["query"]["bytes"] == ((8 + 1 + 8) * 4 * n + wb_bf16
                                       + head_row + b_f32)
    assert costs["query"]["side_bytes"] == 2 * 4 * (7 * 256 + 200) * n


def net(cfg, seed=0):
    """Geometric init plus seeded noise, so no layer sits at its init
    pattern."""
    gen = torch.Generator().manual_seed(seed)
    params = tudf.init_udf_params(gen, cfg, device="cpu")
    return {k: {n: t + 0.05 * torch.randn(t.shape, generator=gen)
                for n, t in layer.items()} for k, layer in params.items()}


def points(n, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, n), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, n))
    return x


def test_value_and_grad_routes_cpu_tensors_to_the_plain_version():
    """On the CPU the wrapper takes value_and_grad_plain at the bf16 tier
    too (the tier the wgmma kernels serve) and counts no launch."""
    cfg = tudf.UDFConfig(precision="default", **TOY)
    w, b = (t.detach() for t in tq.pack_weights(net(cfg), cfg))
    x = torch.as_tensor(points(192))
    before = dict(tq.value_and_grad.tier_launches)
    got = tq.value_and_grad(x, w, b, cfg)
    want = tq.value_and_grad_plain(x, w, b, cfg)
    assert all(torch.equal(g, c) for g, c in zip(got, want))
    assert tq.value_and_grad.tier_launches == before


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


# tests/test_torch_precision.py's QUERY_RTOL["default"] (udf, grad): two
# bf16 computations of one function differ by sparse one-ulp flips of the
# same operands (measured there 4.9e-4 / 5.0e-3 at the toy width).
QUERY_RTOL_BF16 = (2e-3, 1.5e-2)


@pytest.mark.parametrize("udf_type", ["abs", "square"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_plain_query_matches_pallas_on_a_ragged_n(name, udf_type):
    """value_and_grad_plain at "default" (the function the wgmma kernels
    compute and are held against on the card) against the JAX package's
    _pallas_value_and_grad in interpret mode, fuse_pe=True and
    f32_residuals=True as its training forward runs it, at 192 points: a
    multiple of 64 and not of 128, the last 128-point block of the wgmma
    kernels half empty (the Pallas kernel in 64-point tiles). Weights from
    a numpy seed through params_from_numpy."""
    over = CFGS[name]
    jcfg = judf.UDFConfig(precision="default", udf_type=udf_type, **over)
    cfg = tudf.UDFConfig(precision="default", udf_type=udf_type, **over)
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32),
        judf.init_udf_params(jax.random.key(0), jcfg))
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, cfg, device="cpu")["udf"]
    w, b = (t.detach() for t in tq.pack_weights(tp, cfg))
    x = points(192)
    ut, gt = tq.value_and_grad_plain(torch.as_tensor(x), w, b, cfg)
    wj, bj = jq.pack_weights(jax.tree.map(jnp.asarray, jp), jcfg, fuse_pe=True)
    uj, gj = jq._pallas_value_and_grad(jnp.asarray(x), wj, bj, jcfg, 64, True,
                                       f32_residuals=True, fuse_pe=True)
    assert gt.shape == gj.shape == (8, 192)
    u_tol, g_tol = QUERY_RTOL_BF16
    assert max_rel(ut.numpy(), uj) < u_tol
    assert max_rel(gt.numpy(), gj) < g_tol
    # and nearer JAX's "default" than its fp32 "highest"
    jhi = dataclasses.replace(jcfg, precision="highest")
    whi, bhi = jq.pack_weights(jax.tree.map(jnp.asarray, jp), jhi,
                               fuse_pe=True)
    _, gh = jq._pallas_value_and_grad(jnp.asarray(x), whi, bhi, jhi, 64, True,
                                      f32_residuals=True, fuse_pe=True)
    assert max_rel(gt.numpy(), gj) < max_rel(gt.numpy(), gh)
