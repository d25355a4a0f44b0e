"""The port's CUDA kernels on the card, against their plain PyTorch
versions and against plain autograd. Marked `cuda`: they skip without a
GPU. This file imports neither jax nor the JAX package, so it also runs
where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq
from emap_tpu_torch.kernels import mlp_train as tt

CFGS = {
    "toy-abs": tudf.UDFConfig(d_hidden=64, n_layers=8, multires=6),
    "toy-square": tudf.UDFConfig(d_hidden=64, n_layers=8, multires=6,
                                 udf_type="square"),
    "abc": tudf.UDFConfig(),
    # Replica.conf's field: multires 6, d0 39 padded to 40, the skip layer
    # taking 217 + 39 inputs
    "replica": tudf.UDFConfig(multires=6),
}


def max_rel(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def net(cfg, device):
    """Geometric init plus seeded noise, so no layer sits at its init
    pattern."""
    gen = torch.Generator().manual_seed(0)
    params = tudf.init_udf_params(gen, cfg, device="cpu")
    return {k: {n: (t + 0.05 * torch.randn(t.shape, generator=gen))
                .to(device) for n, t in layer.items()}
            for k, layer in params.items()}


def points(n, device, seed=1):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, n), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, n))
    ubar = rng.normal(size=(1, n)).astype(np.float32)
    gbar = np.zeros((8, n), np.float32)
    gbar[:3] = rng.normal(size=(3, n))
    return (torch.as_tensor(a).to(device) for a in (x, ubar, gbar))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_kernels_match_plain(cuda, name):
    """Both kernels against their plain versions on the same inputs (max
    rel 1e-4: float32 sums in another order, measured ~1e-6) and one launch
    counted each. The weight and bias gradients are held layer by layer,
    each block against its own largest entry."""
    cfg = CFGS[name]
    x, ubar, gbar = points(4096, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))

    def blocks(out, bwd):
        u, g = out
        return [u, g] + [t for layer in tq.unpack_weights(*bwd, cfg)
                         for t in layer]

    before = (tq.value_and_grad.launches, tt.train_bwd.launches)
    got = blocks(tq.value_and_grad(x, w, b, cfg),
                 tt.train_bwd(x, w, b, ubar, gbar, cfg))
    torch.cuda.synchronize()
    want = blocks(tq.value_and_grad_plain(x, w, b, cfg),
                  tt.train_bwd_plain(x, w, b, ubar, gbar, cfg))
    assert len(want) == 2 + 2 * len(tq.layer_dims(cfg))
    for i, (g, wt) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all())
        assert max_rel(g, wt) < 1e-4, i
    assert (tq.value_and_grad.launches, tt.train_bwd.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_training_kernels_are_deterministic(cuda, name):
    """Two launches of each training kernel on the same inputs agree in
    every bit: udf, grad, W-bar and b-bar (no atomics; the weight-gradient
    partials are summed in a fixed order)."""
    cfg = CFGS[name]
    x, ubar, gbar = points(8192, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    runs = [tq.value_and_grad(x, w, b, cfg)
            + tt.train_bwd(x, w, b, ubar, gbar, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_training_kernels_match_plain_at_step_n(cuda):
    """At ABC width and the training step's N = 1,024 rays x 114 samples =
    116,736 points: both kernels against their plain versions, max rel 1e-4
    per block (udf, grad, each layer's W-bar and b-bar)."""
    cfg = CFGS["abc"]
    x, ubar, gbar = points(116_736, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))

    def blocks(query, bwd):
        return list(query) + [t for layer in tq.unpack_weights(*bwd, cfg)
                              for t in layer]

    got = blocks(tq.value_and_grad(x, w, b, cfg),
                 tt.train_bwd(x, w, b, ubar, gbar, cfg))
    torch.cuda.synchronize()
    want = blocks(tq.value_and_grad_plain(x, w, b, cfg),
                  tt.train_bwd_plain(x, w, b, ubar, gbar, cfg))
    assert len(got) == len(want) == 2 + 2 * 9
    for i, (g, wt) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all())
        assert max_rel(g, wt) < 1e-4, i


@pytest.mark.cuda
def test_cuda_train_query_grads_match_autograd(cuda):
    """(g, v, b) gradients of a loss on the value and the spatial gradient:
    the kernel pair through its autograd.Function vs double-backward
    autograd of the plain field, <= 3e-4 max rel per leaf (the bound the
    JAX package holds its fused kernels to)."""
    cfg = CFGS["toy-abs"]
    rng = np.random.default_rng(2)
    n = 1000  # not a multiple of the 64-point tile: padding is exercised
    pts = torch.as_tensor(rng.uniform(-1, 1, (n, 3)), dtype=torch.float32,
                          device=cuda)
    w_u = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                          device=cuda)
    w_g = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32,
                          device=cuda)

    def grads(query):
        params = net(cfg, cuda)
        leaves = [t.requires_grad_(True) for layer in params.values()
                  for t in layer.values()]
        u, g = query(params, pts, cfg)
        loss = (torch.sum(w_u * u) + torch.sum(w_g * g)
                + 0.1 * torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2))
        return torch.autograd.grad(loss, leaves)

    for gk, ga in zip(grads(tt.udf_train_value_and_gradient),
                      grads(tudf.udf_value_and_gradient)):
        assert max_rel(gk, ga) < 3e-4


# The extraction's bf16 sigmoid residuals against the plain version's:
# two fp32-accurate computations of a sigmoid an ulp apart round at some
# points to neighbouring bf16 values, which moves the gradient by up to
# 5.3e-4 of the block's largest (H100, ABC width, 262,144 points; 5.8e-4
# on the CPU at 32,768). Held to about 4x that.
RESIDUAL_FLIP_RTOL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["abc", "replica"])
@pytest.mark.parametrize("n", [262_144, 300_032])
def test_cuda_extraction_kernels_match_plain(cuda, n, name):
    """At ABC width and at Replica.conf's (multires 6): the value kernel,
    and the value-and-gradient kernel through the extraction's slicing
    wrapper (one launch per SLICE_CAP points), against their plain
    versions, max rel 1e-4 per output; with the extraction's bf16 sigmoid
    residuals (f32_residuals=False) on both sides the gradient is held to
    RESIDUAL_FLIP_RTOL (test_cuda_tf32_query_matches_plain holds it to 1e-4
    given the kernel's own residuals). Above the cap the slices
    concatenate to the unsliced launch bit for bit (each point is computed
    alone)."""
    cfg = CFGS[name]
    x, _, _ = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = (tq.value.launches, tq.value_and_grad.launches)
    u = tq.value(x, w, b, cfg)
    us, gs = tq.value_and_grad_sliced(x, w, b, cfg)
    u32, g32 = tq.value_and_grad_sliced(x, w, b, cfg, f32_residuals=True)
    torch.cuda.synchronize()
    slices = -(-n // tq.SLICE_CAP)
    assert (tq.value.launches, tq.value_and_grad.launches) == (
        before[0] + 1, before[1] + 2 * slices)
    up = tq.value_plain(x, w, b, cfg)
    uvp, gvp = tq.value_and_grad_plain(x, w, b, cfg, f32_residuals=False)
    uvp32, gvp32 = tq.value_and_grad_plain(x, w, b, cfg)
    for got, want, tol in ((u, up, 1e-4), (us, uvp, 1e-4),
                           (gs, gvp, RESIDUAL_FLIP_RTOL), (u32, uvp32, 1e-4),
                           (g32, gvp32, 1e-4)):
        assert bool(torch.isfinite(got).all())
        assert max_rel(got, want) < tol
    if slices > 1:
        uu, gu = tq.value_and_grad(x, w, b, cfg, f32_residuals=False)
        assert torch.equal(us, uu) and torch.equal(gs, gu)


@pytest.mark.cuda
def test_cuda_point_queries_pad_to_the_tile(cuda):
    """query_value / query_value_and_grad on (M, 3) points with M not a
    multiple of the 64-point tile, against the plain field and autograd
    (fp32 residuals, the autograd field's)."""
    cfg = CFGS["toy-abs"]
    params = net(cfg, cuda)
    pts = torch.as_tensor(np.random.default_rng(3).uniform(-1, 1, (1000, 3)),
                          dtype=torch.float32, device=cuda)
    u = tq.query_value(params, pts, cfg)
    uv, g = tq.query_value_and_grad(params, pts, cfg, cap=256,
                                    f32_residuals=True)
    ua, ga = tudf.udf_value_and_gradient(params, pts, cfg)
    assert u.shape == uv.shape == (1000,) and g.shape == (1000, 3)
    assert max_rel(u, ua.detach()) < 1e-4 and max_rel(uv, ua.detach()) < 1e-4
    assert max_rel(g, ga.detach()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("multires", [10, 6])
def test_cuda_value_kernel_matches_plain(cuda, multires, precision):
    """The grid value kernel at ABC width with the ABC conf's multires = 10
    (d0p 64) and the Replica conf's multires = 6 (d0p 40, so the encoded
    tile's 64 rows are part padding) against value_plain at the same tier,
    max rel 1e-4 at 3xTF32 ("high") and BF16_RTOL at the bf16 tier
    ("default"); one launch counted; two launches bit-identical."""
    cfg = tudf.UDFConfig(multires=multires, precision=precision)
    x, _, _ = points(65_536, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = tq.value.launches
    u = tq.value(x, w, b, cfg)
    again = tq.value(x, w, b, cfg)
    torch.cuda.synchronize()
    assert tq.value.launches == before + 2
    assert bool(torch.isfinite(u).all())
    assert max_rel(u, tq.value_plain(x, w, b, cfg)) < (
        BF16_RTOL if precision == "default" else 1e-4)
    assert torch.equal(u, again)


# The bf16 tier ("default") against the plain versions at that tier: the
# same operands rounded, but fp32 sums in another order flip a few bf16
# roundings (one bf16 ulp). Measured on the CPU with these nets (fp32 against
# fp64 sums of the same tier, 4,096 points): udf 1.1e-3 (d_hidden 64) and
# 2.3e-3 (ABC width), gradient 1.7e-3 / 5.4e-3, the worst W-bar block
# 2.7e-3 / 7.1e-3, of the block's largest. Held to 2e-2 per block, and by
# mean error at least BF16_SEPARATION times nearer the bf16 plain version
# than the fp32 one (measured 3.9x for #2 with an fp32 primal and a bf16
# adjoint at ABC width, 12x to 1000x elsewhere).
BF16_RTOL = 2e-2
BF16_SEPARATION = 2.0


def mean_rel(a, b) -> float:
    return float((a - b).abs().mean() / (b.abs().max() + 1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_bf16_tier_matches_plain(cuda, name):
    """Every kernel at the bf16 tier, and #2 at an fp32 primal with a bf16
    adjoint, against its plain version at the same tier per block, and
    nearer it than the fp32 plain version; one launch counted each, under
    its tier."""
    base = CFGS[name]
    x, ubar, gbar = points(4096, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(base,
                                                                 cuda), base))
    fp32 = dataclasses.replace(base, precision="high")

    def held(got, want, want32):
        # separation over the worst block: a block that no product feeds
        # (the head's bias gradient, a sum of ubar * dy) is the same at
        # every tier
        for g, wt in zip(got, want):
            assert bool(torch.isfinite(g).all())
            assert max_rel(g, wt) < BF16_RTOL
        assert BF16_SEPARATION * max(
            mean_rel(g, wt) for g, wt in zip(got, want)) < max(
            mean_rel(g, w32) for g, w32 in zip(got, want32))

    def bwd_blocks(out):
        return [t for layer in tq.unpack_weights(*out, base) for t in layer]

    bf = dataclasses.replace(base, precision="default")
    before = dict(tq.value_and_grad.tier_launches)
    held(tq.value_and_grad(x, w, b, bf), tq.value_and_grad_plain(x, w, b, bf),
         tq.value_and_grad_plain(x, w, b, fp32))
    assert tq.value_and_grad.tier_launches["bf16"] == before["bf16"] + 1
    assert tq.value_and_grad.tier_launches["3xtf32"] == before["3xtf32"]
    before = tq.value.tier_launches["bf16"]
    held([tq.value(x, w, b, bf)], [tq.value_plain(x, w, b, bf)],
         [tq.value_plain(x, w, b, fp32)])
    assert tq.value.tier_launches["bf16"] == before + 1
    for cfg, key in ((bf, "bf16"), (dataclasses.replace(
            fp32, bwd_precision="default"), "3xtf32+bf16")):
        before = tt.train_bwd.tier_launches[key]
        held(bwd_blocks(tt.train_bwd(x, w, b, ubar, gbar, cfg)),
             bwd_blocks(tt.train_bwd_plain(x, w, b, ubar, gbar, cfg)),
             bwd_blocks(tt.train_bwd_plain(x, w, b, ubar, gbar, fp32)))
        assert tt.train_bwd.tier_launches[key] == before + 1


@pytest.mark.cuda
def test_cuda_bf16_tier_at_step_n_and_extraction_slices(cuda):
    """At ABC width and the training step's N = 116,736 points: #1a and #2
    at the bf16 tier against their plain versions per block (BF16_RTOL);
    the sliced extraction query at the bf16 tier over two slices, against
    the plain version and bit-identical to one launch; two launches of each
    training kernel bit-identical."""
    cfg = dataclasses.replace(CFGS["abc"], precision="default")
    x, ubar, gbar = points(116_736, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    runs = [list(tq.value_and_grad(x, w, b, cfg)) + [
        t for layer in tq.unpack_weights(*tt.train_bwd(x, w, b, ubar, gbar,
                                                       cfg), cfg)
        for t in layer] for _ in range(2)]
    torch.cuda.synchronize()
    want = list(tq.value_and_grad_plain(x, w, b, cfg)) + [
        t for layer in tq.unpack_weights(*tt.train_bwd_plain(
            x, w, b, ubar, gbar, cfg), cfg) for t in layer]
    for g, again, wt in zip(*runs, want):
        assert torch.equal(g, again)
        assert max_rel(g, wt) < BF16_RTOL
    xs, _, _ = points(300_032, cuda)
    us, gs = tq.value_and_grad_sliced(xs, w, b, cfg)
    uu, gu = tq.value_and_grad(xs, w, b, cfg, f32_residuals=False)
    assert torch.equal(us, uu) and torch.equal(gs, gu)
    up, gp = tq.value_and_grad_plain(xs, w, b, cfg, f32_residuals=False)
    assert max_rel(us, up) < BF16_RTOL and max_rel(gs, gp) < BF16_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["mlp_query", "mlp_train", "mlp_value",
                                 "mlp_train_wgmma", "mlp_query_wgmma",
                                 "mlp_query_tf32", "mlp_value_tf32",
                                 "mlp_train_tf32", "mlp_value_wgmma"])
def test_cuda_kernels_run_on_tensor_cores(cuda, lib):
    """Each kernel library's SASS holds tensor-core instructions: HMMA
    (mma.sync), or HGMMA (wgmma) in the wgmma libraries."""
    import shutil
    import subprocess

    from emap_tpu_torch.kernels import build

    build.load(lib)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.lib_path(lib)],
                          capture_output=True, text=True, check=True).stdout
    assert sass.count("HGMMA" if lib.endswith(("_wgmma", "_tf32"))
                      else "HMMA") > 0


# The wgmma kernels (#2 at the bf16 pair) against train_bwd_plain at that
# pair: chip_smoke.py's bf16 gates, 1e-2 of each W-bar / b-bar block's
# largest entry (a bf16 flip is 2^-7 of its term) and a mean error at least
# BF16_SEPARATION times smaller than against the fp32 plain version.
WGMMA_RTOL = 1e-2


def _bwd_blocks(out, cfg):
    return [t for layer in tq.unpack_weights(*out, cfg) for t in layer]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4160])
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_wgmma_train_bwd_matches_plain(cuda, name, n):
    """train_bwd at the (bf16, bf16) pair launches the wgmma kernels: per
    block within WGMMA_RTOL of train_bwd_plain at that pair and nearer it
    than the fp32 plain version, two launches bit-identical, one launch
    counted under "bf16". n = 4160 is 32.5 blocks of 128 points: the last
    block's second warpgroup holds no point."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, ubar, gbar = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tt.train_bwd.tier_launches)
    runs = [_bwd_blocks(tt.train_bwd(x, w, b, ubar, gbar, cfg), cfg)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tt.train_bwd.tier_launches["bf16"] == before["bf16"] + 2
    assert all(tt.train_bwd.tier_launches[k] == v
               for k, v in before.items() if k != "bf16")
    want = _bwd_blocks(tt.train_bwd_plain(x, w, b, ubar, gbar, cfg), cfg)
    want32 = _bwd_blocks(tt.train_bwd_plain(
        x, w, b, ubar, gbar, dataclasses.replace(cfg, precision="high")),
        cfg)
    for i, (g, again, wt) in enumerate(zip(*runs, want)):
        assert torch.equal(g, again), i
        assert bool(torch.isfinite(g).all()), i
        assert max_rel(g, wt) < WGMMA_RTOL, i
    assert BF16_SEPARATION * max(
        mean_rel(g, wt) for g, wt in zip(runs[0], want)) < max(
        mean_rel(g, w32) for g, w32 in zip(runs[0], want32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["abc", "replica"])
def test_cuda_wgmma_train_bwd_at_step_n(cuda, name):
    """At the training step's N = 116,736 points, ABC and Replica width: the
    wgmma kernels against train_bwd_plain at the bf16 pair per block, and
    bit-identical across two launches."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, ubar, gbar = points(116_736, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    runs = [_bwd_blocks(tt.train_bwd(x, w, b, ubar, gbar, cfg), cfg)
            for _ in range(2)]
    torch.cuda.synchronize()
    want = _bwd_blocks(tt.train_bwd_plain(x, w, b, ubar, gbar, cfg), cfg)
    for i, (g, again, wt) in enumerate(zip(*runs, want)):
        assert torch.equal(g, again), i
        assert max_rel(g, wt) < WGMMA_RTOL, i


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_wgmma_pack_and_plan(cuda, name):
    """The wgmma prologue equals pack_weights_bf16 bit for bit, and the
    library reckons a launch's scratch and shared memory as wgmma_plan."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, ubar, gbar = points(4160, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    parts = tt.train_bwd_wgmma_parts(x, w, b, ubar, gbar, cfg)
    assert torch.equal(parts["wb"], tt.pack_weights_bf16(w, cfg))
    plan = tt.wgmma_plan(cfg, 4160)
    sizes = tt.wgmma_sizes(cfg, 4160)
    assert sizes == {"wb": plan["wb"], "frows": plan["frows"],
                     "side": plan["side"], "partials": plan["partials"],
                     "per_point_smem": plan["smem"]["per_point"],
                     "gemm_smem": plan["smem"]["gemm"],
                     "blocks": plan["blocks"]}


def _query_held(got, want, want32):
    """#1a at the bf16 tier against value_and_grad_plain at that tier:
    udf and grad within WGMMA_RTOL of each block's largest, the gradient up
    to the abs head's sign at points whose udf lies within that bound of 0
    (there y0 is within the tier's roundoff of the surface, where d|y0|/dy0
    turns over), and by mean error at least BF16_SEPARATION times nearer
    than the fp32 plain version."""
    (u, g), (uw, gw), (u32, g32) = got, want, want32
    flip = (g + gw).abs().amax(0) < (g - gw).abs().amax(0)
    assert not bool((uw[flip] > WGMMA_RTOL * uw.max()).any())
    g = torch.where(flip, -g, g)
    for a, c in ((u, uw), (g, gw)):
        assert bool(torch.isfinite(a).all())
        assert max_rel(a, c) < WGMMA_RTOL
    assert BF16_SEPARATION * max(mean_rel(u, uw), mean_rel(g, gw)) < max(
        mean_rel(u, u32), mean_rel(g, g32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [116_736, 4160])
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_wgmma_query_matches_plain(cuda, name, n):
    """value_and_grad at the bf16 tier launches #1a's wgmma kernels
    (csrc/mlp_query_wgmma.cu): against value_and_grad_plain at that tier
    (_query_held), at the training step's N = 116,736 points and at
    n = 4160, 32.5 blocks of 128 points (the last block's second warpgroup
    holds no point and writes nothing); ABC width (d0p 64), Replica's (d0p
    40) and the toy nets; two launches bit-identical; one launch counted a
    call under "bf16"; rows 3-7 of grad zero."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, _, _ = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tq.value_and_grad.tier_launches)
    runs = [tq.value_and_grad(x, w, b, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert tq.value_and_grad.tier_launches == dict(
        before, bf16=before["bf16"] + 2)
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    assert runs[0][0].shape == (n,) and runs[0][1].shape == (8, n)
    assert not bool(runs[0][1][3:].any())
    _query_held(runs[0], tq.value_and_grad_plain(x, w, b, cfg),
                tq.value_and_grad_plain(
                    x, w, b, dataclasses.replace(cfg, precision="high")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["abc", "replica"])
def test_cuda_wgmma_query_through_slices(cuda, name):
    """value_and_grad_sliced at the bf16 tier over slices of 4,096 points
    (10,176 points: slices of 4,096, 4,096 and 1,984, the last a ragged
    block): one launch a slice, the concatenation bit-identical to one
    launch over all points with the same bf16 residuals, and held against
    the plain version with them."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, _, _ = points(10_176, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = tq.value_and_grad.tier_launches["bf16"]
    sliced = tq.value_and_grad_sliced(x, w, b, cfg, cap=4096)
    assert tq.value_and_grad.tier_launches["bf16"] == before + 3
    whole = tq.value_and_grad(x, w, b, cfg, f32_residuals=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(sliced, whole))
    _query_held(sliced, tq.value_and_grad_plain(x, w, b, cfg,
                                                f32_residuals=False),
                tq.value_and_grad_plain(
                    x, w, b, dataclasses.replace(cfg, precision="high")))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["abc", "replica"])
def test_cuda_wgmma_query_in_a_cuda_graph(cuda, name):
    """value_and_grad at the bf16 tier captured in a CUDA graph (its
    tensor map a __grid_constant__ parameter, its scratch from the graph's
    pool): the capture counts one launch, and replays on new points written
    into the captured input equal eager launches bit for bit."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, _, _ = points(8192, cuda)
    x2, _, _ = points(8192, cuda, seed=5)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    want = [tq.value_and_grad(p, w, b, cfg) for p in (x, x2)]
    static = x.clone()
    tq.value_and_grad(static, w, b, cfg)  # warm-up: the library loaded
    torch.cuda.synchronize()
    before = tq.value_and_grad.tier_launches["bf16"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tq.value_and_grad(static, w, b, cfg)
    assert tq.value_and_grad.tier_launches["bf16"] == before + 1
    for p, (u, g) in zip((x, x2), want):
        static.copy_(p)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], u) and torch.equal(out[1], g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_wgmma_query_pack_plan_and_twin(cuda, name):
    """#1a's wgmma prologue equals pack_weights_bf16 bit for bit; the
    library reckons a launch's scratch and shared memory as
    query_wgmma_plan; the parts' outputs are the wrapper's; and the
    mma.sync bf16 twin (csrc/mlp_query.cu, timed beside it) still matches
    the plain version. Neither counts a launch."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, _, _ = points(4160, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tq.value_and_grad.tier_launches)
    parts = tq.value_and_grad_wgmma_parts(x, w, b, cfg)
    twin = tq.value_and_grad_mma_sync(x, w, b, cfg)
    torch.cuda.synchronize()
    assert tq.value_and_grad.tier_launches == before
    assert torch.equal(parts["wb"], tq.pack_weights_bf16(w, cfg))
    u, g = tq.value_and_grad(x, w, b, cfg)
    assert torch.equal(parts["udf"], u) and torch.equal(parts["grad"], g)
    plan = tq.query_wgmma_plan(cfg, 4160)
    assert tq.query_wgmma_sizes(cfg, 4160) == {
        "wb": plan["wb"], "side": plan["side"], "smem": plan["smem"],
        "blocks": plan["blocks"]}
    _query_held(twin, tq.value_and_grad_plain(x, w, b, cfg),
                tq.value_and_grad_plain(
                    x, w, b, dataclasses.replace(cfg, precision="high")))


# The 3xTF32 query kernels (csrc/mlp_query_tf32.cu) against
# value_and_grad_plain at "high": fp32-accurate products summed in another
# order, 1e-4 of each block's largest (chip_smoke.py's KERNEL_RTOL), the
# gradient up to the abs head's sign where y0 lies within fp32 roundoff of
# the surface. With bf16 residuals the plain version multiplies by the
# kernel's own (side_residuals): two fp32-accurate computations round a
# sigmoid an ulp apart to neighbouring bf16 values at some points, which
# moves their gradient by up to 5.8e-4 of the block's largest (measured on
# the CPU at ABC width, 32,768 points); each residual is held to one bf16
# rounding of the plain sigmoid. sigmoid(100 z) carries z's fp32 roundoff a
# hundredfold: the kernel's fp32 residuals lie up to 1.7e-5 from the plain
# ones (H100, ABC width), held to RESIDUAL_ATOL.
TF32_RTOL = 1e-4
RESIDUAL_ATOL = 1e-4


def _tf32_held(got, want):
    (u, g), (uw, gw) = got, want
    flip = (g + gw).abs().amax(0) < (g - gw).abs().amax(0)
    assert not bool((uw[flip] > TF32_RTOL * uw.max()).any())
    g = torch.where(flip, -g, g)
    for a, c in ((u, uw), (g, gw)):
        assert bool(torch.isfinite(a).all())
        assert max_rel(a, c) < TF32_RTOL


def _residuals_held(side, x, w, b, cfg, f32_residuals):
    """The kernel's residuals, decoded from its side scratch: within fp32
    roundoff of the plain sigmoids, or (bf16) each the bf16 rounding of a
    value within fp32 roundoff of the plain sigmoid. Returns them."""
    n = x.shape[1]
    got = tq.side_residuals(side, cfg, n)
    want = tq.plain_residuals(x, w, b, cfg)
    assert side.dtype == (torch.float32 if f32_residuals else torch.bfloat16)
    for r, s in zip(got, want):
        tol = 0.0 if f32_residuals else 2.0 ** -8
        assert bool(((r - s).abs() <= tol * s.abs() + RESIDUAL_ATOL).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("f32_residuals", [True, False])
@pytest.mark.parametrize("n", [116_736, 4160])
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_tf32_query_matches_plain(cuda, name, n, f32_residuals):
    """value_and_grad at "high" launches the 3xTF32 kernels: against
    value_and_grad_plain with the same residuals (_tf32_held), at the
    training step's N = 116,736 points and at n = 4160 (65 blocks of 64),
    ABC width (d0p 64: lin0's reverse product m64n64k8), Replica's (d0p 40:
    m64n40k8) and the toy nets; two launches bit-identical; one launch
    counted a call under "3xtf32"; rows 3-7 of grad zero."""
    cfg = dataclasses.replace(CFGS[name], precision="high")
    x, _, _ = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tq.value_and_grad.tier_launches)
    runs = [tq.value_and_grad(x, w, b, cfg, f32_residuals=f32_residuals)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert tq.value_and_grad.tier_launches == dict(
        before, **{"3xtf32": before["3xtf32"] + 2})
    assert all(torch.equal(a, c) for a, c in zip(*runs))
    assert runs[0][0].shape == (n,) and runs[0][1].shape == (8, n)
    assert not bool(runs[0][1][3:].any())
    parts = tq.value_and_grad_tf32_parts(x, w, b, cfg,
                                         f32_residuals=f32_residuals)
    assert torch.equal(parts["udf"], runs[0][0])
    assert torch.equal(parts["grad"], runs[0][1])
    res = _residuals_held(parts["side"], x, w, b, cfg, f32_residuals)
    _tf32_held(runs[0], tq.value_and_grad_plain(
        x, w, b, cfg, residuals=None if f32_residuals else res))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["abc", "replica"])
def test_cuda_tf32_query_through_slices(cuda, name):
    """value_and_grad_sliced at "high" (bf16 residuals, the extraction's)
    over slices of 4,096 points (10,176 points: 4,096, 4,096 and 1,984):
    one launch a slice, the concatenation bit-identical to one launch over
    all points; and at "highest", whose residuals stay fp32, held against
    the plain version."""
    cfg = dataclasses.replace(CFGS[name], precision="high")
    x, _, _ = points(10_176, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = tq.value_and_grad.tier_launches["3xtf32"]
    sliced = tq.value_and_grad_sliced(x, w, b, cfg, cap=4096)
    assert tq.value_and_grad.tier_launches["3xtf32"] == before + 3
    whole = tq.value_and_grad(x, w, b, cfg, f32_residuals=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(sliced, whole))
    highest = dataclasses.replace(cfg, precision="highest")
    _tf32_held(tq.value_and_grad_sliced(x, w, b, highest, cap=4096),
               tq.value_and_grad_plain(x, w, b, highest))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["abc", "replica"])
def test_cuda_tf32_query_in_a_cuda_graph(cuda, name):
    """value_and_grad at "high" captured in a CUDA graph (its tensor map a
    __grid_constant__ parameter, its scratch from the graph's pool): the
    capture counts one launch, and replays on new points written into the
    captured input equal eager launches bit for bit."""
    cfg = dataclasses.replace(CFGS[name], precision="high")
    x, _, _ = points(8192, cuda)
    x2, _, _ = points(8192, cuda, seed=5)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    want = [tq.value_and_grad(p, w, b, cfg) for p in (x, x2)]
    static = x.clone()
    tq.value_and_grad(static, w, b, cfg)  # warm-up: the library loaded
    torch.cuda.synchronize()
    before = tq.value_and_grad.tier_launches["3xtf32"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tq.value_and_grad(static, w, b, cfg)
    assert tq.value_and_grad.tier_launches["3xtf32"] == before + 1
    for p, (u, g) in zip((x, x2), want):
        static.copy_(p)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], u) and torch.equal(out[1], g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_tf32_query_pack_plan_and_twin(cuda, name):
    """The 3xTF32 prologue equals pack_weights_tf32 bit for bit; the
    library reckons a launch's scratch and shared memory as
    query_tf32_plan; and the mma.sync twin (csrc/mlp_query.cu, timed beside
    it) still matches the plain version. Neither counts a launch."""
    cfg = dataclasses.replace(CFGS[name], precision="high")
    x, _, _ = points(4160, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tq.value_and_grad.tier_launches)
    parts = tq.value_and_grad_tf32_parts(x, w, b, cfg)
    twin = tq.value_and_grad_mma_sync(x, w, b, cfg)
    torch.cuda.synchronize()
    assert tq.value_and_grad.tier_launches == before
    assert torch.equal(parts["pack"], tq.pack_weights_tf32(w, cfg))
    plan = tq.query_tf32_plan(cfg, 4160)
    assert tq.query_tf32_sizes(cfg, 4160) == {
        "pack": plan["pack"], "side": plan["side"], "smem": plan["smem"],
        "blocks": plan["blocks"]}
    _tf32_held(twin, tq.value_and_grad_plain(x, w, b, cfg))


# The 3xTF32 grid value kernels (csrc/mlp_value_tf32.cu) against value_plain
# at "high": fp32-accurate products summed in another order, TF32_RTOL of
# the largest udf (chip_smoke.py's KERNEL_RTOL).


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65_536, 4160])
@pytest.mark.parametrize("name", ["abc", "replica", "toy-square"])
def test_cuda_value_tf32_matches_plain(cuda, name, n):
    """value at "high" launches the 3xTF32 value kernels: against
    value_plain within TF32_RTOL at ABC width (d0p 64), Replica's (d0p 40)
    and a toy square-head net, at 65,536 points and at 4,160 (65 tiles of
    64: the last block's second consumer has none); two launches
    bit-identical; one launch counted a call under "3xtf32";
    value_tf32_parts' udf the same bits, its prologue's pack
    pack_weights_tf32's forward blocks bit for bit; the library reckons the
    launch as value_tf32_plan on this card; value_tf32_parts and the
    mma.sync twin (csrc/mlp_value.cu, timed beside it), which still matches
    the plain version, count no launch."""
    cfg = dataclasses.replace(CFGS[name], precision="high")
    x, _, _ = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tq.value.tier_launches)
    runs = [tq.value(x, w, b, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert tq.value.tier_launches == dict(
        before, **{"3xtf32": before["3xtf32"] + 2})
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (n,)
    assert bool(torch.isfinite(runs[0]).all())
    want = tq.value_plain(x, w, b, cfg)
    assert max_rel(runs[0], want) < TF32_RTOL
    parts = tq.value_tf32_parts(x, w, b, cfg)
    twin = tq.value_mma_sync(x, w, b, cfg)
    torch.cuda.synchronize()
    assert tq.value.tier_launches["3xtf32"] == before["3xtf32"] + 2
    assert torch.equal(parts["udf"], runs[0])
    assert torch.equal(parts["pack"],
                       tq.pack_weights_tf32(w, cfg, transposed=False))
    plan = tq.value_tf32_plan(cfg, n, sms=torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert tq.value_tf32_sizes(cfg, n) == {
        "pack": plan["pack"], "smem": plan["smem"], "blocks": plan["blocks"],
        "tiles": plan["tiles"]}
    assert max_rel(twin, want) < TF32_RTOL


@pytest.mark.cuda
def test_cuda_value_tf32_runs_hgmma_tf32_only(cuda):
    """The 3xTF32 value library's SASS holds wgmma at TF32 (HGMMA.*.TF32)
    and no mma.sync (HMMA)."""
    import re
    import shutil
    import subprocess

    from emap_tpu_torch.kernels import build

    build.load("mlp_value_tf32")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.lib_path("mlp_value_tf32")],
                          capture_output=True, text=True, check=True).stdout
    assert re.search(r"HGMMA\.\S*TF32", sass)
    assert "HMMA" not in sass


# The bf16 grid value kernels (csrc/mlp_value_wgmma.cu) against value_plain
# at "default": the same bf16 operands, fp32 sums in another order and the
# special function unit's softplus (within 3e-9 of the exact value) flip a
# few bf16 roundings: BF16_RTOL of the largest udf, and by mean error at
# least BF16_SEPARATION times nearer the bf16 plain version than the fp32
# one.


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65_536, 4160])
@pytest.mark.parametrize("name", ["abc", "replica", "toy-square"])
def test_cuda_value_wgmma_matches_plain(cuda, name, n):
    """value at "default" launches the bf16 value kernels: against
    value_plain within BF16_RTOL at ABC width (d0p 64), Replica's (d0p 40)
    and a toy square-head net, at 65,536 points and at 4,160 (65 tiles of
    64: the last block's second consumer has none), and by mean error at
    least BF16_SEPARATION times nearer it than the fp32 plain version; two
    launches bit-identical; one launch counted a call under "bf16";
    value_wgmma_parts' udf the same bits, its prologue's pack
    pack_weights_bf16 bit for bit; the library reckons the launch as
    value_wgmma_plan on this card; value_wgmma_parts and the mma.sync twin
    (csrc/mlp_value.cu, timed beside it), which still matches the plain
    version, count no launch."""
    cfg = dataclasses.replace(CFGS[name], precision="default")
    x, _, _ = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tq.value.tier_launches)
    runs = [tq.value(x, w, b, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert tq.value.tier_launches == dict(before, bf16=before["bf16"] + 2)
    assert torch.equal(runs[0], runs[1]) and runs[0].shape == (n,)
    assert bool(torch.isfinite(runs[0]).all())
    want = tq.value_plain(x, w, b, cfg)
    want32 = tq.value_plain(x, w, b, dataclasses.replace(cfg,
                                                         precision="high"))
    assert max_rel(runs[0], want) < BF16_RTOL
    assert BF16_SEPARATION * mean_rel(runs[0], want) < mean_rel(runs[0],
                                                                 want32)
    parts = tq.value_wgmma_parts(x, w, b, cfg)
    twin = tq.value_mma_sync(x, w, b, cfg)
    torch.cuda.synchronize()
    assert tq.value.tier_launches["bf16"] == before["bf16"] + 2
    assert torch.equal(parts["udf"], runs[0])
    assert torch.equal(parts["wb"], tq.pack_weights_bf16(w, cfg))
    plan = tq.value_wgmma_plan(cfg, n, sms=torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert tq.value_wgmma_sizes(cfg, n) == {
        "wb": plan["wb"], "smem": plan["smem"], "blocks": plan["blocks"],
        "tiles": plan["tiles"]}
    assert max_rel(twin, want) < BF16_RTOL


@pytest.mark.cuda
def test_cuda_value_wgmma_runs_hgmma_only(cuda):
    """The bf16 value library's SASS holds wgmma (HGMMA) and no mma.sync
    (HMMA)."""
    import shutil
    import subprocess

    from emap_tpu_torch.kernels import build

    build.load("mlp_value_wgmma")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", build.lib_path("mlp_value_wgmma")],
                          capture_output=True, text=True, check=True).stdout
    assert "HGMMA" in sass
    assert "HMMA" not in sass


@pytest.mark.cuda
@pytest.mark.parametrize("lib, kernel, plan", [
    ("mlp_value_tf32", "value_tf32_kernel", "value_tf32_plan"),
    ("mlp_value_wgmma", "value_wgmma_kernel", "value_wgmma_plan")])
def test_cuda_value_kernels_compile_to_their_planned_registers(cuda, lib,
                                                               kernel, plan):
    """ptxas compiles each value kernel to the registers a thread its plan
    gives (the launch bound of a 384-thread block), with no byte spilled."""
    from emap_tpu_torch.kernels import build

    build.load(lib)
    report = build.parse_ptxas(build.build_log(lib))
    regs = getattr(tq, plan)(tudf.UDFConfig(), 128 ** 3)["registers"]
    assert [v for k, v in report.items() if kernel in k] == [
        {"registers": regs["compiled"], "spill_bytes": 0}]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "high"])
def test_cuda_value_refuses_a_skip_at_the_head(cuda, precision):
    """A net whose head takes a skip, which the wgmma value kernels of both
    tiers refuse (they sum the head's dot from the last hidden layer's
    outputs alone), raises on the card: no launch, no fall-back."""
    cfg = tudf.UDFConfig(d_hidden=64, n_layers=8, multires=6,
                         skip_in=(4, 8), precision=precision)
    x, _, _ = points(4096, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tq.value.tier_launches)
    with pytest.raises(ValueError):
        tq.value(x, w, b, cfg)
    assert tq.value.tier_launches == before


def _fixture_script():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "torch_query_tf32_fixture.py")
    spec = importlib.util.spec_from_file_location("query_tf32_fixture", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_cuda_query_tf32_equals_its_stored_launch(cuda):
    """The 3xTF32 query kernel (csrc/mlp_query_tf32.cu), whose TF32
    machinery moved into csrc/mlp_tf32.cuh, gives the outputs its build
    before the move gave on the same inputs, bit for bit: udf and the
    gradient at "high" with fp32 and with bf16 residuals, on the integer-
    hashed inputs of scripts/torch_query_tf32_fixture.py at ABC width
    (tests/fixtures/query_tf32_launch.npz, stored by that script from the
    earlier build on an H100)."""
    fixture = _fixture_script()
    cfg = dataclasses.replace(tudf.UDFConfig(), precision="high")
    x, w, b = (torch.as_tensor(a).to(cuda)
               for a in fixture.hashed_inputs(cfg))
    stored = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "fixtures", "query_tf32_launch.npz"))
    for tag, f32 in (("f32", True), ("bf16", False)):
        udf, grad = tq.value_and_grad(x, w, b, cfg, f32_residuals=f32)
        torch.cuda.synchronize()
        for got, key in ((udf, f"udf_{tag}"), (grad[:3], f"grad_{tag}")):
            want = torch.as_tensor(stored[key]).to(cuda)
            assert torch.equal(got.contiguous().view(torch.int32),
                               want.contiguous().view(torch.int32)), key


# #2 at the pairs with a 3xTF32 tier (csrc/mlp_train_tf32.cu) against
# train_bwd_plain at the same pair, each W-bar / b-bar block against its own
# largest entry: TF32_RTOL at the 3xTF32 pair, WGMMA_RTOL with a bf16 tier,
# whose mean error must also sit BF16_SEPARATION times nearer the pair's
# plain version than the fp32 one.
TRAIN_TF32_PAIRS = {"3xtf32": ("high", ""), "3xtf32+bf16": ("high", "default"),
                    "bf16+3xtf32": ("default", "high")}


def _train_tf32_held(got, x, w, b, ubar, gbar, cfg):
    want = _bwd_blocks(tt.train_bwd_plain(x, w, b, ubar, gbar, cfg), cfg)
    got = _bwd_blocks(got, cfg)
    bf16 = "default" in (cfg.precision, cfg.bwd_precision)
    for i, (g, wt) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(g).all()), i
        assert max_rel(g, wt) < (WGMMA_RTOL if bf16 else TF32_RTOL), i
    if bf16:
        want32 = _bwd_blocks(tt.train_bwd_plain(x, w, b, ubar, gbar,
                                                dataclasses.replace(
                                                    cfg, precision="high",
                                                    bwd_precision="")), cfg)
        assert BF16_SEPARATION * max(
            mean_rel(g, wt) for g, wt in zip(got, want)) < max(
            mean_rel(g, w32) for g, w32 in zip(got, want32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4160])
@pytest.mark.parametrize("pair", list(TRAIN_TF32_PAIRS))
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_train_tf32_matches_plain(cuda, name, pair, n):
    """train_bwd at each pair with a 3xTF32 tier launches
    csrc/mlp_train_tf32.cu: held against train_bwd_plain at that pair per
    block, two launches bit-identical, two launches counted under the
    pair's name and no other. n = 4160 is 65 blocks of 64 points, not a
    multiple of the GEMM's point ranges' 64-point rounding."""
    precision, bwd = TRAIN_TF32_PAIRS[pair]
    cfg = dataclasses.replace(CFGS[name], precision=precision,
                              bwd_precision=bwd)
    x, ubar, gbar = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tt.train_bwd.tier_launches)
    runs = [tt.train_bwd(x, w, b, ubar, gbar, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    assert tt.train_bwd.tier_launches == dict(before,
                                              **{pair: before[pair] + 2})
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    _train_tf32_held(runs[0], x, w, b, ubar, gbar, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["3xtf32", "3xtf32+bf16"])
@pytest.mark.parametrize("name", ["abc", "replica"])
def test_cuda_train_tf32_at_step_n(cuda, name, pair):
    """At the training step's N = 116,736 points, ABC and Replica width:
    the kernels against train_bwd_plain at the pair per block, and
    bit-identical across two launches."""
    precision, bwd = TRAIN_TF32_PAIRS[pair]
    cfg = dataclasses.replace(CFGS[name], precision=precision,
                              bwd_precision=bwd)
    x, ubar, gbar = points(116_736, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    runs = [tt.train_bwd(x, w, b, ubar, gbar, cfg) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)
    _train_tf32_held(runs[0], x, w, b, ubar, gbar, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", list(TRAIN_TF32_PAIRS))
@pytest.mark.parametrize("name", list(CFGS))
def test_cuda_train_tf32_launches_and_plan(cuda, name, pair):
    """Each launch against its plain version: the 3xTF32 pack equals
    pack_weights_tf32 and the bf16 one pack_weights_bf16, bit for bit; the
    per-point kernel's factors contracted in fp32 (wbar_from_factors) and
    its bias partials' sum against the plain factors' (the pair's
    tolerance); the GEMM's range partials in order against the plain
    contraction of the kernel's own factors (the 3xTF32 GEMM's sum order,
    wbar_tf32_from_factors, or the bf16 one's fp32 sums: TF32_RTOL); the
    reduce against the in-order sums of the partials (TF32_RTOL). The
    library reckons a launch's scratch and shared memory as
    train_tf32_plan, and the mma.sync twin still matches the plain
    version. Neither counts a launch."""
    precision, bwd = TRAIN_TF32_PAIRS[pair]
    cfg = dataclasses.replace(CFGS[name], precision=precision,
                              bwd_precision=bwd)
    n = 4160
    x, ubar, gbar = points(n, cuda)
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg, cuda),
                                                             cfg))
    before = dict(tt.train_bwd.tier_launches)
    parts = tt.train_bwd_tf32_parts(x, w, b, ubar, gbar, cfg)
    twin = tt.train_bwd_mma_sync(x, w, b, ubar, gbar, cfg)
    torch.cuda.synchronize()
    assert tt.train_bwd.tier_launches == before
    assert torch.equal(parts["pack"], tq.pack_weights_tf32(w, cfg))
    if pair == "3xtf32":
        assert parts["wb"] is None
    else:
        assert torch.equal(parts["wb"], tt.pack_weights_bf16(w, cfg))
    tol = TF32_RTOL if pair == "3xtf32" else WGMMA_RTOL

    def in_order(part):
        out = part[0]
        for k in range(1, part.shape[0]):
            out = out + part[k]
        return out

    factors, bbar = tt.train_bwd_factors(x, w, b, ubar, gbar, cfg)
    zero_b = torch.zeros_like(parts["bbar"])
    got = _bwd_blocks((tt.wbar_from_factors(parts["factors"], cfg),
                       in_order(parts["bpart"])), cfg)
    want = _bwd_blocks((tt.wbar_from_factors(factors, cfg), bbar), cfg)
    assert parts["factors"].dtype == factors.dtype
    for i, (g, wt) in enumerate(zip(got, want)):
        assert max_rel(g, wt) < tol, i
    plain_gemm = (tt.wbar_tf32_from_factors if bwd != "default"
                  else tt.wbar_from_factors)(parts["factors"], cfg)
    lay = tt.wgmma_layout(cfg)
    mask = torch.zeros_like(parts["wbar"], dtype=torch.bool)
    off = 0
    for i, o in lay["dims"]:
        mask[:o, off: off + i] = True
        off += i
    reduced = torch.where(mask, in_order(parts["wpart"]), 0.0)
    for i, (g, wt) in enumerate(zip(_bwd_blocks((reduced, zero_b), cfg),
                                    _bwd_blocks((plain_gemm, zero_b), cfg))):
        assert max_rel(g, wt) < TF32_RTOL, i
    for g, wt in zip(_bwd_blocks((parts["wbar"], parts["bbar"]), cfg),
                     _bwd_blocks((reduced, in_order(parts["bpart"])), cfg)):
        assert max_rel(g, wt) < TF32_RTOL
    plan = tt.train_tf32_plan(cfg, n)
    assert tt.train_tf32_sizes(cfg, n) == {
        "pack": plan["pack"], "wb": plan["wb"], "frows": plan["frows"],
        "side": plan["side"], "partials": plan["partials"],
        "per_point_smem": plan["smem"]["per_point"],
        "gemm_smem": plan["smem"]["gemm"], "blocks": plan["blocks"]}
    _train_tf32_held(twin, x, w, b, ubar, gbar, cfg)


def _train_fixture_script():
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "torch_train_wgmma_fixture.py")
    spec = importlib.util.spec_from_file_location("train_wgmma_fixture",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_cuda_train_wgmma_equals_its_stored_launch(cuda):
    """#2's wgmma kernels at the (bf16, bf16) pair, whose GEMM and reduce
    moved into csrc/mlp_train_gemm.cuh, give the W-bar and b-bar their
    build before the move gave on the same inputs, bit for bit: the
    integer-hashed inputs of scripts/torch_train_wgmma_fixture.py at ABC
    width (tests/fixtures/train_wgmma_launch.npz, stored by that script
    from the earlier build on an H100)."""
    fixture = _train_fixture_script()
    cfg = dataclasses.replace(tudf.UDFConfig(), precision="default")
    args = [torch.as_tensor(a).to(cuda) for a in fixture.hashed_inputs(cfg)]
    stored = np.load(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "fixtures", "train_wgmma_launch.npz"))
    wbar, bbar = tt.train_bwd(*args, cfg)
    torch.cuda.synchronize()
    for got, key in ((wbar, "wbar"), (bbar, "bbar")):
        want = torch.as_tensor(stored[key]).to(cuda)
        assert torch.equal(got.contiguous().view(torch.int32),
                           want.contiguous().view(torch.int32)), key


def _train_conf(tmp_path, upsampling_type):
    """confs/ABC.conf at d_hidden 64 on a 3-view 32x32 cube."""
    from emap_tpu_torch import config
    from emap_tpu_torch.data import make_synthetic_scene

    data_dir = str(tmp_path / "data")
    make_synthetic_scene(data_dir, scan="cube000", n_views=3, H=32, W=32)
    conf = config.parse_file(os.path.join(os.path.dirname(os.path.dirname(
        __file__)), "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = str(tmp_path / "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    conf["train.batch_size"] = 64
    conf["model.udf_network.d_hidden"] = 64
    conf["model.udf_renderer.upsampling_type"] = upsampling_type
    return conf


def _runner(conf):
    from emap_tpu_torch.train.runner import Runner

    return Runner(conf, "train", device="cuda")


def _snapshot(state) -> dict:
    """Every tensor of a TrainState on the host: parameters, Adam moments
    and counts, gates, step, and the generator's state."""
    from emap_tpu_torch.ckpt.convert import checkpoint_payload

    def flat(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: v for key in sorted(tree)
                    for k, v in flat(tree[key], f"{prefix}{key}/").items()}
        return {prefix.rstrip("/"): np.asarray(tree)}

    out = flat(checkpoint_payload(state, 0.0))
    out["generator"] = state.generator.get_state().numpy()
    return out


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _step_fns(runner, chain):
    from emap_tpu_torch.train import step as tstep

    args = (runner.tcfg, runner.rcfg, runner.ucfg, runner.scene.n_images)
    return (tstep.build_train_step(*args),
            tstep.build_chained_train_step(*args, chain))


def _eager_rows(runner, n):
    from emap_tpu_torch.train import step as tstep

    single, _ = _step_fns(runner, 1)
    return torch.stack([tstep.pack_metrics(single(runner.state, runner.pool))
                        for _ in range(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("upsampling_type", ["classical", "mix"])
def test_cuda_graph_steps_equal_eager_steps(cuda, tmp_path, upsampling_type):
    """8 steps replayed from a CUDA graph of the step (two chained calls of
    4: a warm-up step and the capture, 3 replays, then 4 replays) against 8
    eager steps from the same state: every parameter, Adam moment and
    count, gate, the step, the generator's state and the metric rows, bit
    for bit; the kernel launches as reckoned."""
    conf = _train_conf(tmp_path, upsampling_type)
    eager, graphed = _runner(conf), _runner(conf)
    want = _eager_rows(eager, 8)
    _, chained = _step_fns(graphed, 4)
    got = torch.cat([chained(graphed.state, graphed.pool) for _ in range(2)])
    torch.cuda.synchronize()
    assert graphed.state.step == eager.state.step == 8
    assert torch.equal(got, want)
    _assert_same(_snapshot(graphed.state), _snapshot(eager.state))
    # the capture counted one launch of each training kernel that the
    # graph holds, at the conf's bf16 tier; 7 replays ran them
    assert graphed.tiers["field"] == graphed.tiers["adjoint"] == "default"
    assert {k: v for k, v in chained.captured_launches.items() if v} == {
        "mlp_value_and_grad/bf16": 1, "mlp_train_bwd/bf16": 1}
    assert {k: v for k, v in chained.replayed_launches.items() if v} == {
        "mlp_value_and_grad/bf16": 7, "mlp_train_bwd/bf16": 7}
    chained.release()


@pytest.mark.cuda
def test_cuda_graph_capture_leaves_the_state_untouched(cuda, tmp_path):
    """A chain of 1 runs the warm-up step and captures the next without
    replaying it: the state after it is that of one eager step, the
    generator's included, and the next steps replay as eager ones."""
    conf = _train_conf(tmp_path, "classical")
    eager, graphed = _runner(conf), _runner(conf)
    want = _eager_rows(eager, 1)
    _, chained = _step_fns(graphed, 1)
    got = chained(graphed.state, graphed.pool)
    torch.cuda.synchronize()
    assert chained.graph is not None and graphed.state.step == 1
    assert torch.equal(got, want)
    _assert_same(_snapshot(graphed.state), _snapshot(eager.state))
    more = torch.cat([chained(graphed.state, graphed.pool) for _ in range(3)])
    assert torch.equal(more, _eager_rows(eager, 3))
    _assert_same(_snapshot(graphed.state), _snapshot(eager.state))
    chained.release()


@pytest.mark.cuda
def test_cuda_graph_warm_up_reads_its_inputs(cuda, tmp_path):
    """Each capture's warm-up step reads the inputs the host set for it,
    not the zeros they are made with: 8 captures in a row (a chain of 1
    each) leave the state of 8 eager steps. The inputs were once made after
    the side stream's wait on the main stream, so their zero fills could
    land after the side stream's `set`, now and then."""
    conf = _train_conf(tmp_path, "classical")
    eager, graphed = _runner(conf), _runner(conf)
    want = _eager_rows(eager, 8)
    rows = []
    for _ in range(8):
        _, chained = _step_fns(graphed, 1)
        rows.append(chained(graphed.state, graphed.pool))
        torch.cuda.synchronize()
        chained.release()
    assert torch.equal(torch.cat(rows), want)
    _assert_same(_snapshot(graphed.state), _snapshot(eager.state))


@pytest.mark.cuda
def test_cuda_graph_stop_and_resume_is_exact(cuda, tmp_path):
    """Replays stopped after 4 steps, the state saved to the host and
    restored into a new state object (the generator's state with it), and
    4 more steps from a new capture: the state and rows of 8 steps that did
    not stop."""
    from emap_tpu_torch.ckpt.convert import state_from_payload

    conf = _train_conf(tmp_path, "classical")
    whole, split = _runner(conf), _runner(conf)
    _, chained = _step_fns(whole, 4)
    want = torch.cat([chained(whole.state, whole.pool) for _ in range(2)])
    chained.release()
    _, first = _step_fns(split, 4)
    rows = [first(split.state, split.pool)]
    first.release()
    from emap_tpu_torch.ckpt.convert import checkpoint_payload

    payload = checkpoint_payload(split.state, 1.0)
    gen = split.state.generator.get_state()
    split.state = state_from_payload(payload, split.ucfg, split.tcfg.seed,
                                     "cuda")
    split.state.generator.set_state(gen)
    _, second = _step_fns(split, 4)
    rows.append(second(split.state, split.pool))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(rows), want)
    _assert_same(_snapshot(split.state), _snapshot(whole.state))
    second.release()
