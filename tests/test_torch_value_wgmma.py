"""The Python side of the bf16 grid value kernels
(emap_tpu_torch/csrc/mlp_value_wgmma.cu), which the CPU reaches: the launch
plan (shared memory, registers, the weight chunks a pair of tiles streams),
the FLOP, bytes and special-function operations of each launch, the
wrapper's route for CPU tensors, and the kernel's numbers (bf16 operands,
64-deep promoted chunks, the softplus in the special function unit's form)
emulated on the CPU against the JAX package's Pallas value kernel at
"default" in interpret mode. The kernels run only on the card
(tests/test_torch_cuda.py).
"""

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
from emap_tpu_torch.kernels import build
from emap_tpu_torch.kernels import mlp_query as tq

TOY = dict(d_hidden=64, n_layers=8, multires=6)
# ABC.conf's field (multires 10: d0p 64), Replica.conf's (multires 6: d0p
# 40, the skip layer taking 217 + 39 inputs) and a toy net
CFGS = {"abc": {}, "replica": {"multires": 6}, "toy": TOY}
GRID_N = 128 ** 3  # an ABC extraction's grid pass
# The kernel's constants (csrc/mlp_value_wgmma.cu): 100 log2(e), ln(2)/100.
LOG2E_100 = np.float32(144.269504)
LN2_100 = np.float32(0.0069314718)
# The emulated kernel against the Pallas kernel at "default": both round
# the same operands to bf16, but the Pallas kernel's PE is XLA's and its
# sums run in another order, so where that roundoff straddles a bf16
# rounding boundary the two round an operand to neighbouring bf16 values
# (a flip: 2^-8 to 2^-7 of its term), which the layers after it carry on.
# Measured over these nets and the points of seeds 8 and 9: max rel 8.2e-4
# to 4.1e-3 of the largest udf (value_plain: 6.9e-5 to 2.6e-3), and by mean
# error 4.4x (Replica width, where value_plain sits 4.4x to 4.9x nearer
# too) to 123x nearer the Pallas kernel at "default" than at "highest".
# Held to chip_smoke.py's bf16 bounds: a little above one flip (1e-2) and
# at least 2x nearer its own tier.
RTOL = 1e-2
SEPARATION = 2.0


@pytest.mark.parametrize("name", sorted(CFGS))
def test_value_wgmma_plan_fits(name):
    """A block's shared memory (the chain engine's 4-stage ring of 64 x 128
    bf16 chunks and two consumers' two 64-point x 256-feature bf16 tiles,
    the biases of 15 hidden layers and the head's row in fp32, the
    mbarriers, the alignment) fits the H100's 232,448 bytes at ABC, Replica
    and toy widths, as an exact sum of its parts; a consumer's accumulators
    (a 128-wide half's running sum and its chunk's) fit the 168 registers a
    thread that ptxas compiles a 384-thread block to, and the run-time
    split (two consumers' 232, the producer warpgroup's 40) fits the SM's
    65,536; the grid is one block an SM or one a pair of 64-point tiles,
    whichever is fewer."""
    cfg = tudf.UDFConfig(**CFGS[name])
    plan = tq.value_wgmma_plan(cfg, GRID_N)
    assert plan["smem_parts"] == {
        "weight ring (4 stages of a 64 x 128 bf16 chunk)": 4 * 16_384,
        "activation tiles (2 warpgroups x 2)": 4 * 32_768,
        "mbarriers": 64, "alignment": 1024,
        "biases (15 hidden layers x 256 fp32)": 15_360,
        "head row (256 fp32)": 1024}
    assert plan["smem"] == 65_536 + 131_072 + 64 + 1024 + 15_360 + 1024 \
        == 214_080
    assert plan["smem"] <= tq.SMEM_LIMIT == 232_448
    regs = plan["registers"]
    assert regs["accumulators"] + regs["chunk_accumulators"] == 128 \
        < regs["compiled"] == 65_536 // 384 - 2
    assert 2 * 128 * regs["consumer"] + 128 * regs["producer"] <= 65_536
    assert plan["tiles"] == GRID_N // 64 == 32_768
    assert plan["pairs"] == 16_384
    assert plan["blocks"] == tq.H100_SMS == 132
    small = tq.value_wgmma_plan(cfg, 4160)  # the last pair: one tile
    assert (small["tiles"], small["pairs"], small["blocks"]) == (65, 33, 33)
    assert plan["wb"] == 256 * tq.wgmma_layout(cfg)["ldwb"]


@pytest.mark.parametrize("over", [{"d_hidden": 320}, {"d_hidden": 512},
                                  {"skip_in": (4, 8)}])
def test_value_wgmma_plan_refuses_what_does_not_fit(over):
    """A layer wider than the 256-feature tile (d_hidden 320, 512), or a
    skip at the head (the kernel sums the head's dot in registers from the
    last hidden layer's outputs alone), is refused before any launch, on
    every device."""
    with pytest.raises(ValueError):
        tq.value_wgmma_plan(tudf.UDFConfig(**over), GRID_N)


# ptxas' report (-Xptxas -v) as nvcc prints it for csrc/mlp_value_wgmma.cu,
# with a device function's spills between the two entries
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN18value_wgmma_kernelE' for 'sm_90a'
ptxas info    : Function properties for _ZN18value_wgmma_kernelE
    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 16 barriers, 32 bytes cumulative \
stack size
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Compiling entry function '_Z11pack_kernelPKfPt' for 'sm_90a'
ptxas info    : Function properties for _Z11pack_kernelPKfPt
    0 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 20 registers, used 0 barriers
"""


def test_ptxas_report_reads_each_entry():
    """build.parse_ptxas reads each entry function's registers and spilled
    bytes from ptxas' report, the spills of a device function between two
    entries left out: what chip_smoke.py holds value_wgmma_plan's compiled
    registers (and no spill) against on the card."""
    assert build.parse_ptxas(PTXAS_LOG) == {
        "_ZN18value_wgmma_kernelE": {"registers": 168, "spill_bytes": 0},
        "_Z11pack_kernelPKfPt": {"registers": 20, "spill_bytes": 20}}
    assert build.parse_ptxas("") == {}


@pytest.mark.parametrize("name, chunks", [("abc", 58), ("replica", 58),
                                          ("toy", 8)])
def test_value_wgmma_stream_of_a_pair(name, chunks):
    """A pair of 64-point tiles streams each hidden layer's 128-wide halves
    x its 64-deep chunks of 64 x 128 bf16 (16,384 bytes): at ABC and
    Replica width lin0's 2 (its 40 or 64 encoded rows padded to one chunk)
    and the other 7 layers' 8 (lin3's 193 or 217 outputs fill the second
    half with part zeros), 950,272 bytes, the bf16 weights of every hidden
    layer; at toy width one half of one chunk each."""
    plan = tq.value_wgmma_plan(tudf.UDFConfig(**CFGS[name]), GRID_N)
    assert plan["chunks_per_pair"] == chunks
    assert plan["stream_bytes_per_pair"] == chunks * 2 * 64 * 64 * 2
    if name == "abc":
        assert plan["stream_bytes_per_pair"] == 950_272 == 2 * 256 * (
            64 + 7 * 256)


def test_value_wgmma_launch_costs_match_a_hand_count():
    """At ABC width and a 128^3 grid pass (2,097,152 points): 2 x 459,008
    FLOP a point of forward products (1.93 TFLOP); the value launch must
    move its points (8 rows), its udf, the bf16 pack (read once), the
    head's row and the biases; the pack launch reads W and writes the
    pack; the 16,384 pairs stream 950,272 bytes each; the softplus of the
    1,985 hidden outputs a point take two special-function operations
    each."""
    cfg = tudf.UDFConfig()
    n = GRID_N
    costs = tq.value_wgmma_launch_costs(cfg, n)
    wb_bytes = 2 * 256 * 2112
    assert costs["value"]["flops"] == 2 * 459_008 * n == 1_925_219_090_432
    assert costs["value"]["bytes"] == 4 * 9 * n + wb_bytes + 4 * 256 \
        + 4 * 256 * 9
    assert costs["pack"] == {"flops": 0, "bytes": 4 * 256 * 2112 + wb_bytes}
    assert costs["value"]["stream_bytes"] == 16_384 * 950_272
    assert 256 * 7 + 193 == 1985
    assert costs["value"]["sfu_ops"] == 2 * 1985 * n == 8_325_693_440


def net(cfg, seed=0):
    """Geometric init plus seeded noise, so no layer sits at its init
    pattern."""
    gen = torch.Generator().manual_seed(seed)
    params = tudf.init_udf_params(gen, cfg, device="cpu")
    return {k: {n: t + 0.05 * torch.randn(t.shape, generator=gen)
                for n, t in layer.items()} for k, layer in params.items()}


def test_cpu_tensors_at_tier_1_reach_the_plain_version(monkeypatch):
    """On CPU tensors value at "default" (kernel tier 1) is value_plain bit
    for bit, loads no kernel library and counts no launch."""
    cfg = tudf.UDFConfig(precision="default", **TOY)
    assert tq.kernel_tier(cfg.precision) == 1
    w, b = (t.detach().contiguous() for t in tq.pack_weights(net(cfg), cfg))
    rng = np.random.default_rng(1)
    x = torch.zeros(8, 256)
    x[:3] = torch.as_tensor(rng.uniform(-1, 1, (3, 256)), dtype=torch.float32)

    def refuse(name):
        raise AssertionError(f"a CPU call loaded the {name} library")

    monkeypatch.setattr(build, "load", refuse)
    counts = (tq.value.launches, dict(tq.value.tier_launches))
    assert torch.equal(tq.value(x, w, b, cfg), tq.value_plain(x, w, b, cfg))
    assert (tq.value.launches, tq.value.tier_launches) == counts


def softplus_form(u, c):
    """The kernel's softplus from u = 100 log2(e) z (csrc/mlp_value_wgmma.cu:
    softplus_u) in fp32, with exact exp2 and log2 in place of the special
    function unit's ex2.approx and lg2.approx."""
    e = torch.exp2(-u.abs())
    return (torch.clamp(u, min=0.0) + torch.log2(1.0 + e)) * c


def test_softplus_form_against_softplus100():
    """The form's own error, besides the special function unit's (2^-22 of
    lg2, absolute): within 3e-9 plus 2^-21 of the value of
    softplus(100 z)/100 in fp64, over z in [-1, 1], where 1 + e drops e's
    low bits (at u < -23 the form gives u's part alone); exactly 0 at the
    bias past a layer's outputs, u = -1e30."""
    z = torch.linspace(-1.0, 1.0, 200_001, dtype=torch.float32)
    got = softplus_form(z * LOG2E_100, torch.tensor(LN2_100))
    t = z.double() * 100.0
    want = (t.clamp(min=0.0) + torch.log1p(torch.exp(-t.abs()))) / 100.0
    assert bool(((got.double() - want).abs()
                 <= 3e-9 + 2.0 ** -21 * want.abs()).all())
    assert float(softplus_form(torch.tensor([-1e30]),
                               torch.tensor(LN2_100))[0]) == 0.0


def value_wgmma_emulated(x_T, w_pack, b_pack, cfg):
    """udf at raw points x_T (8, N) as the bf16 value kernel computes it:
    per hidden layer the activations (points x kpad_l, zero past in_l)
    rounded to bf16 against the prologue's bf16 pack, each 64-deep chunk's
    product summed on its own and added to the running sum in fp32, the
    first chunk's as the running sum; u = 100 log2(e) acc + 100 log2(e) b;
    softplus_form with ln2 / 100 (x 1/sqrt2 ahead of the skip, where the
    encoded x x 1/sqrt2 follows); the head's dot of the bf16-rounded
    activations and head row in fp32, plus its bias."""
    lay = tq.wgmma_layout(cfg)
    wb = tq.pack_weights_bf16(w_pack, cfg).float()
    layers = tq.unpack_weights(w_pack, b_pack, cfg)
    x, _ = tq.encode_fused(x_T, cfg)
    d0 = cfg.dims[0]
    inv = torch.tensor(tq.INV_SQRT2, dtype=torch.float32)
    h = x.T
    for l, ((_, o), k, col) in enumerate(zip(lay["dims"][:-1], lay["kpad"],
                                             lay["offb"])):
        a = tudf.round_bf16(torch.nn.functional.pad(h, (0, k - h.shape[1])))
        wl = wb[:o, col: col + k]
        acc = a[:, :64] @ wl[:, :64].T
        for c in range(64, k, 64):
            acc = acc + a[:, c: c + 64] @ wl[:, c: c + 64].T
        u = acc * LOG2E_100 + layers[l][1][None, :] * LOG2E_100
        skip = (l + 1) in cfg.skip_in
        c_l = torch.tensor(LN2_100) * inv if skip else torch.tensor(LN2_100)
        h = softplus_form(u, c_l)
        if skip:
            h = torch.cat([h, x[:d0].T * inv], dim=1)
    w_head, b_head = layers[-1]
    y0 = (tudf.round_bf16(h) * tudf.round_bf16(w_head[0])[None, :]).sum(1)
    return tq.head_value(y0 + b_head[0], cfg)


def jax_net(over, udf_type, precision):
    """A JAX net with geometric init plus numpy noise, its torch twin's
    packed weights, and both configs."""
    jcfg = judf.UDFConfig(precision=precision, udf_type=udf_type, **over)
    tcfg = tudf.UDFConfig(precision=precision, udf_type=udf_type, **over)
    jp = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(0),
                                                       jcfg))
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape))
                      .astype(np.float32), jp)
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, tcfg, device="cpu")["udf"]
    wt, bt = (t.detach() for t in tq.pack_weights(tp, tcfg, fuse_pe=True))
    return jp, jcfg, tcfg, wt, bt


@pytest.mark.parametrize("udf_type", ["abs", "square"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_kernel_numbers_against_pallas_value(name, udf_type):
    """The bf16 value kernel's numbers, emulated (value_wgmma_emulated),
    against the JAX package's _pallas_value in interpret mode at "default"
    (host PE, unpermuted weights, as pallas_udf_value calls it) on the same
    seeded net and 256 points from a numpy seed, at ABC, Replica and toy
    width, abs and square heads: max relative error within RTOL, and by
    mean error at least SEPARATION times nearer the Pallas kernel at
    "default" than at "highest"; the emulation is not the bf16 plain
    version."""
    over = CFGS[name]
    jp, jcfg, tcfg, wt, bt = jax_net(over, udf_type, "default")
    rng = np.random.default_rng(8)
    x = np.zeros((8, 256), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, 256))
    xt = torch.as_tensor(x)

    def pallas(precision):
        cfg = dataclasses.replace(jcfg, precision=precision)
        wj, bj = jq.pack_weights(jax.tree.map(jnp.asarray, jp), cfg)
        return np.asarray(jq._pallas_value(
            jq._encode_host(jnp.asarray(x[:3].T), cfg), wj, bj, cfg, 128,
            True), np.float64)

    got = np.asarray(value_wgmma_emulated(xt, wt, bt, tcfg), np.float64)
    assert not np.array_equal(got, np.asarray(tq.value_plain(xt, wt, bt,
                                                             tcfg)))
    uj, uh = pallas("default"), pallas("highest")
    scale = np.abs(uj).max()
    assert np.abs(got - uj).max() / scale < RTOL
    assert np.abs(got - uh).mean() > SEPARATION * np.abs(got - uj).mean()
