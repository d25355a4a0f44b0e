"""The Python side of the 3xTF32 grid value kernels
(emap_tpu_torch/csrc/mlp_value_tf32.cu), which the CPU reaches: the launch
plan (shared memory, registers, the weight entries a tile streams), the
FLOP and bytes of each launch, the forward-only weight pack's plain
version, the wrapper's route for CPU tensors, and the kernel's sum order
emulated on the CPU against the JAX package's Pallas value kernel in
interpret mode. The kernels run only on the card (tests/test_torch_cuda.py).
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
# 3xTF32 against the Pallas kernel at "highest": the split drops lo*lo and
# rounds lo (~2^-22 of each product), the sums run in another order; the
# bound of tests/test_torch_tf32.py::RTOL, which a dropped cross term
# (~2^-11) breaks.
RTOL = 1e-5


@pytest.mark.parametrize("name", sorted(CFGS))
def test_value_tf32_plan_fits(name):
    """A block's shared memory (two consumers' 3-stage rings of 64 x 32
    fp32 entries, hi and lo; the 64-point x 256-feature fp32 activation
    tile; the consumers' head sums; the mbarriers; the alignment) fits the
    H100's 232,448 bytes at ABC, Replica and toy widths, as an exact sum
    of its parts; a consumer's data registers (a pass's accumulators and
    its chunk's, two sets of split A fragments, a held pass) fit the 168 a
    thread that ptxas compiles a 384-thread block to, and the run-time
    split (two consumers' 232, the producer warpgroup's 40) fits the SM's
    65,536; the grid is one block an SM or one a 64-point tile, whichever
    is fewer."""
    cfg = tudf.UDFConfig(**CFGS[name])
    plan = tq.value_tf32_plan(cfg, GRID_N)
    assert plan["smem_parts"] == {
        "weight rings (2 consumers x 3 stages of 64 x 32 fp32, hi and lo)":
            2 * 3 * 16_384,
        "activation tile (64 points x 256 fp32)": 65_536,
        "head sums (2 consumers x 64 points)": 512,
        "mbarriers": 96, "alignment": 1024}
    assert plan["smem"] == 98_304 + 65_536 + 512 + 96 + 1024 == 165_472
    assert plan["smem"] <= tq.SMEM_LIMIT == 232_448
    regs = plan["registers"]
    assert regs["pass_accumulators"] + regs["chunk_accumulators"] \
        + regs["a_fragments"] + regs["held"] == 160 \
        < regs["compiled"] == 65_536 // 384 - 2
    assert 2 * 128 * regs["consumer"] + 128 * regs["producer"] <= 65_536
    assert plan["tiles"] == GRID_N // 64 == 32_768
    assert plan["blocks"] == tq.H100_SMS == 132
    assert tq.value_tf32_plan(cfg, 4160)["blocks"] == 65  # 65 tiles
    lay = tq.query_tf32_layout(cfg)
    assert plan["pack"] == 512 * lay["ldf"]


@pytest.mark.parametrize("over", [{"d_hidden": 320}, {"d_hidden": 512},
                                  {"skip_in": (4, 8)}])
def test_value_tf32_plan_refuses_what_does_not_fit(over):
    """A layer wider than the 256-feature tile (d_hidden 320, 512), or a
    skip at the head (the kernel sums the head's dot in registers from the
    last hidden layer's outputs alone), is refused before any launch, on
    every device."""
    with pytest.raises(ValueError):
        tq.value_tf32_plan(tudf.UDFConfig(**over), GRID_N)


def test_value_tf32_entries_and_stream_at_abc_width():
    """At ABC width a 64-point tile streams 116 weight chunks of 128
    outputs x 32 contraction steps (lin0's 2 chunks and the other 7
    layers' 8, two 128-wide halves each; lin3's 193 outputs fill the
    second half with 65 rows), that is 232 ring entries of 64 rows, hi and
    lo (16 KB): 3,801,088 bytes from L2, the forward half of the query
    kernel's stream."""
    cfg = tudf.UDFConfig()
    plan = tq.value_tf32_plan(cfg, GRID_N)
    assert plan["chunks_per_tile"] == 2 * 2 + 7 * 8 * 2 == 116
    assert plan["entries_per_tile"] == 4 * 2 + 7 * 4 * 8 == 232
    assert plan["stream_bytes_per_tile"] == 232 * 2 * 64 * 32 * 4 \
        == 3_801_088


def test_value_tf32_launch_costs_match_a_hand_count():
    """At ABC width and a 128^3 grid pass (2,097,152 points): 2 x 459,008
    FLOP a point of forward products (1.93 TFLOP); the value launch must
    move its points (8 rows), its udf, the forward-only pack (read once),
    the head's row and the biases; the pack launch reads W and writes the
    pack; the tiles stream 32,768 x 3,801,088 bytes of weight entries."""
    cfg = tudf.UDFConfig()
    n = GRID_N
    costs = tq.value_tf32_launch_costs(cfg, n)
    pack_bytes = 4 * 512 * 1856
    assert costs["value"]["flops"] == 2 * 459_008 * n == 1_925_219_090_432
    assert costs["value"]["bytes"] == 4 * 9 * n + pack_bytes + 4 * 256 \
        + 4 * 256 * 9
    assert costs["pack"] == {"flops": 0,
                             "bytes": 4 * 256 * 2112 + pack_bytes}
    assert costs["value"]["stream_bytes"] == 32_768 * 3_801_088


def net(cfg, seed=0):
    """Geometric init plus seeded noise, so no layer sits at its init
    pattern."""
    gen = torch.Generator().manual_seed(seed)
    params = tudf.init_udf_params(gen, cfg, device="cpu")
    return {k: {n: t + 0.05 * torch.randn(t.shape, generator=gen)
                for n, t in layer.items()} for k, layer in params.items()}


def packed(cfg):
    return tuple(t.detach().contiguous() for t in tq.pack_weights(net(cfg),
                                                                  cfg))


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_pack_twin_reconstructs_every_w(name):
    """The forward-only pack (the value kernel's prologue's plain version)
    is the first ldf columns of the query kernels' pack, bit for bit, and
    its hi + lo reconstructs every hidden layer's W to 2^-22 of each
    entry's magnitude, with no transposed block."""
    cfg = tudf.UDFConfig(**CFGS[name])
    w, b = packed(cfg)
    fwd = tq.pack_weights_tf32(w, cfg, transposed=False)
    lay = tq.query_tf32_layout(cfg)
    assert fwd.shape == (512, lay["ldf"]) and fwd.dtype == torch.float32
    assert torch.equal(fwd, tq.pack_weights_tf32(w, cfg)[:, : lay["ldf"]])
    blocks = tq.unpack_weights(w, b, cfg)[:-1]
    got = tq.unpack_weights_tf32(fwd, cfg)
    assert len(got) == len(blocks)
    for (wl, _), (g, trans) in zip(blocks, got):
        assert trans is None and g.shape == wl.shape
        assert bool(((g - wl).abs() <= 2.0 ** -22 * wl.abs()).all())


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_cpu_tensors_at_tier_0_reach_the_plain_version(precision,
                                                       monkeypatch):
    """On CPU tensors value at "high" and "highest" (kernel tier 0) is
    value_plain bit for bit, loads no kernel library and counts no
    launch."""
    cfg = dataclasses.replace(tudf.UDFConfig(**TOY), precision=precision)
    assert tq.kernel_tier(cfg.precision) == 0
    w, b = packed(cfg)
    rng = np.random.default_rng(1)
    x = torch.zeros(8, 256)
    x[:3] = torch.as_tensor(rng.uniform(-1, 1, (3, 256)), dtype=torch.float32)

    def refuse(name):
        raise AssertionError(f"a CPU call loaded the {name} library")

    monkeypatch.setattr(build, "load", refuse)
    counts = (tq.value.launches, dict(tq.value.tier_launches))
    assert torch.equal(tq.value(x, w, b, cfg), tq.value_plain(x, w, b, cfg))
    assert (tq.value.launches, tq.value.tier_launches) == counts


def value_tf32_emulated(x_T, w_pack, b_pack, cfg):
    """udf at raw points x_T (8, N) as the 3xTF32 value kernel sums it:
    per hidden layer the activations (points x kf_l, zero past in_l) split
    into TF32 hi and lo against the forward-only pack's hi and lo (the
    prologue's, its column order undone), each 8-step k8 product lo*hi,
    hi*lo, then hi*hi into a fresh accumulator a 32-step chunk, added to
    the running sum in fp32; softplus(100 z)/100, x 1/sqrt2 ahead of the
    skip; the head's dot grouped as the kernel groups it: each consumer's
    passes of 64 features (alternate passes) split over the four threads
    of a quad (features 8 g + 2 q + {0, 1}), their sums added as (s0 + s1)
    + (s2 + s3), then the two consumers' sums and the bias."""
    pack = tq.pack_weights_tf32(w_pack, cfg, transposed=False)
    lay = tq.query_tf32_layout(cfg)
    inv = [tq.TF32_PERM.index(p) for p in range(8)]
    layers = tq.unpack_weights(w_pack, b_pack, cfg)
    x, _ = tq.encode_fused(x_T, cfg)
    d0, n = cfg.dims[0], x_T.shape[1]
    h = x.T
    for l, ((i, o), kf, cf) in enumerate(zip(lay["dims"], lay["kf"],
                                             lay["offf"])):
        if l in cfg.skip_in:
            h = torch.cat([h, x[:d0].T], dim=1) * tq.INV_SQRT2
        a = torch.nn.functional.pad(h, (0, kf - h.shape[1]))
        cols = tq._perm_columns(kf, inv, "cpu")
        bh = pack[:o, cf: cf + kf][:, cols]
        bl = pack[256: 256 + o, cf: cf + kf][:, cols]
        ah, al = tq.split_tf32(a)
        acc = torch.zeros(n, o)
        for c in range(0, kf, tq.TF32_CHUNK):
            part = torch.zeros(n, o)
            for s in range(c, c + tq.TF32_CHUNK, 8):
                ks = slice(s, s + 8)
                part = part + al[:, ks] @ bh[:, ks].T
                part = part + ah[:, ks] @ bl[:, ks].T
                part = part + ah[:, ks] @ bh[:, ks].T
            acc = acc + part
        h = tudf.softplus100(acc + layers[l][1][None, :])
    w_head, b_head = layers[-1]
    m = h.shape[1]
    prod = torch.nn.functional.pad(h * w_head[0][None, :m], (0, 256 - m))
    # (point, pass, group, quad thread, pair)
    prod = prod.view(n, 4, 8, 4, 2)
    sums = []
    for c in range(2):
        s = prod[:, c::2].permute(0, 3, 1, 2, 4).reshape(n, 4, -1).sum(-1)
        sums.append((s[:, 0] + s[:, 1]) + (s[:, 2] + s[:, 3]))
    y0 = (sums[0] + sums[1]) + b_head[0]
    return tq.head_value(y0, cfg)


@pytest.mark.parametrize("name", ["abc", "replica"])
def test_kernel_sum_order_against_pallas_value(name):
    """The value kernel's numbers, emulated (value_tf32_emulated), against
    the JAX package's _pallas_value in interpret mode at "highest" (host
    PE, unpermuted weights, as pallas_udf_value calls it) on the same
    seeded net and 256 points from a numpy seed: max relative error within
    RTOL at ABC width and at Replica's; the fp32 plain version agrees as
    well, and the emulation is not the fp32 one."""
    over = CFGS[name]
    jcfg = judf.UDFConfig(precision="highest", **over)
    tcfg = tudf.UDFConfig(precision="highest", **over)
    jp = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(0),
                                                       jcfg))
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (a + 0.05 * rng.normal(size=a.shape))
                      .astype(np.float32), jp)
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, tcfg, device="cpu")["udf"]
    wt, bt = (t.detach() for t in tq.pack_weights(tp, tcfg, fuse_pe=True))
    x = np.zeros((8, 256), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, 256))
    xt = torch.as_tensor(x)
    wj, bj = jq.pack_weights(jax.tree.map(jnp.asarray, jp), jcfg)
    uj = np.asarray(jq._pallas_value(jq._encode_host(jnp.asarray(x[:3].T),
                                                     jcfg), wj, bj, jcfg,
                                     128, True), np.float64)
    got = value_tf32_emulated(xt, wt, bt, tcfg)
    f32 = tq.value_plain(xt, wt, bt, tcfg)
    assert not torch.equal(got, f32)  # the emulation did run

    def rel(a):
        a = np.asarray(a, np.float64)
        return float(np.abs(a - uj).max() / np.abs(uj).max())

    assert rel(got) < RTOL
    assert rel(f32) < RTOL
