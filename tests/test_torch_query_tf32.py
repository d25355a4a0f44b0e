"""The Python side of the 3xTF32 query kernels (csrc/mlp_query_tf32.cu),
which the CPU reaches: the launch plan (shared memory, registers, scratch,
the weight chunks a block streams), the FLOP and bytes of each launch, the
plain version of the weight-pack prologue, the plain twin of one promoted
3xTF32 product held against fp64, and the wrapper's route for CPU tensors.
The kernels run only on the card (tests/test_torch_cuda.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq

TOY = dict(d_hidden=64, n_layers=8, multires=6)
CFGS = {"abc": {}, "replica": {"multires": 6}, "toy": TOY}
N_STEP = 116_736  # the training step's points: 1,024 rays x 114 samples


@pytest.mark.parametrize("name", sorted(CFGS))
def test_query_tf32_plan_fits(name):
    """A block's shared memory (a 4-stage ring of 128 x 32 fp32 weight
    chunks, hi and lo; one 64-point x 256-feature fp32 activation tile; the
    64 x 64 fp32 d udf / d x-tilde block; the head's sums) fits the H100's
    232,448 bytes at ABC width (d0p 64), Replica's (d0p 40) and the toy
    net's; a consumer's accumulators and split A fragments fit its 232
    registers; the scratch is the (512, ldp) pack and 256 sigmoids a hidden
    layer a point."""
    cfg = tudf.UDFConfig(**CFGS[name])
    plan = tq.query_tf32_plan(cfg, N_STEP)
    assert plan["smem"] == (131_072 + 65_536 + 16_384 + 1_280 + 64 + 1_024
                            ) == 215_360
    assert plan["smem"] <= tq.SMEM_LIMIT
    regs = plan["registers"]
    assert regs["accumulators"] + regs["a_fragments"] < regs["consumer"]
    assert 128 * regs["producer"] + 256 * regs["consumer"] <= 65_536
    assert plan["blocks"] == N_STEP // 64 == 1824
    lay = tq.query_tf32_layout(cfg)
    assert plan["pack"] == 512 * lay["ldp"]
    assert plan["side"] == 1824 * (len(tq.layer_dims(cfg)) - 1) * 256 * 64


def test_query_tf32_layout_and_stream_at_abc_width():
    """At ABC width the pack holds 8 hidden layers: forward blocks 64 + 7 x
    256 columns wide, transposed ones 7 x 256 + 224 (lin3's 193 outputs
    rounded up to 32), 3,872 columns in all (7.9 MB); a block streams 234
    ring entries (7.54 MB) from L2, every product's chunks times its
    halves, lin0's reverse product (64 outputs) one 64-row half."""
    cfg = tudf.UDFConfig()
    lay = tq.query_tf32_layout(cfg)
    assert lay["kf"] == [64] + [256] * 7
    assert lay["kt"] == [256] * 3 + [224] + [256] * 4
    assert (lay["ldf"], lay["ldt"], lay["ldp"]) == (1856, 2016, 3872)
    plan = tq.query_tf32_plan(cfg, N_STEP)
    fwd = 2 * 2 + 7 * 8 * 2  # lin0 2 chunks, the others 8, two halves
    rev = 6 * 8 * 2 + 7 * 2 + 8  # lin3's 7 chunks; lin0's one half
    assert plan["entries_per_block"] == fwd + rev == 234
    assert plan["stream_bytes_per_block"] == 226 * 32_768 + 8 * 16_384


@pytest.mark.parametrize("over", [{"d_hidden": 320}, {"d_hidden": 512},
                                  {"multires": 11}])
def test_query_tf32_plan_refuses_what_does_not_fit(over):
    """A layer wider than the 256-feature tile, or an encoded input wider
    than the 64-row d udf / d x-tilde block (multires 11: d0 69, padded to
    72), is refused before any launch, on every device."""
    with pytest.raises(ValueError):
        tq.query_tf32_plan(tudf.UDFConfig(**over), 4096)


def test_query_tf32_launch_costs_match_a_hand_count_at_abc_width():
    """At ABC width and N = 116,736: 4 x 459,008 FLOP a point of products;
    the query must move its points, outputs, the pack (read once), the
    head's row and the biases; the sigmoid side arrays are 1,992 live rows
    a point, written and read once: fp32 in the training query, bf16 (half
    the bytes) in the extraction's at "high", fp32 again at "highest"."""
    cfg = tudf.UDFConfig()
    n = N_STEP
    costs = tq.query_tf32_launch_costs(cfg, n)
    pack_bytes = 4 * 512 * 3872
    assert costs["query"]["flops"] == 4 * 459_008 * n
    assert costs["query"]["bytes"] == 4 * 17 * n + pack_bytes + 4 * 256 \
        + 4 * 256 * 9
    assert costs["pack"]["bytes"] == 4 * 256 * 2112 + pack_bytes
    assert costs["query"]["side_bytes"] == 2 * 4 * n * 1992
    assert tq.query_tf32_launch_costs(cfg, n, f32_residuals=False)[
        "query"]["side_bytes"] == 2 * 2 * n * 1992
    highest = dataclasses.replace(cfg, precision="highest")
    assert tq.query_tf32_launch_costs(highest, n, f32_residuals=False)[
        "query"]["side_bytes"] == 2 * 4 * n * 1992
    assert costs["query"]["stream_bytes"] == 1824 * tq.query_tf32_plan(
        cfg, n)["stream_bytes_per_block"]


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


def is_tf32(a: torch.Tensor) -> bool:
    """Every value has its 13 low mantissa bits clear."""
    return not bool((a.contiguous().view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("name", sorted(CFGS))
def test_pack_twin_reconstructs_w_and_its_transpose(name):
    """pack_weights_tf32's hi and lo are TF32 values whose sum reconstructs
    every hidden layer's W and W^T to 2^-22 of each entry's magnitude (the
    lo*lo term the split drops), with nothing outside the live blocks; the
    columns of each 8-group hold features (0, 2, 4, 6, 1, 3, 5, 7)."""
    cfg = tudf.UDFConfig(**CFGS[name])
    w, b = packed(cfg)
    pack = tq.pack_weights_tf32(w, cfg)
    lay = tq.query_tf32_layout(cfg)
    assert pack.shape == (512, lay["ldp"]) and pack.dtype == torch.float32
    hi, lo = pack[:256], pack[256:]
    assert is_tf32(hi) and is_tf32(lo)
    assert bool((lo.abs() <= 2.0 ** -11 * hi.abs()).all())
    blocks = tq.unpack_weights(w, b, cfg)[:-1]
    got = tq.unpack_weights_tf32(pack, cfg)
    assert len(got) == len(blocks)
    live = 0
    for (wl, _), (fwd, trans) in zip(blocks, got):
        for g, want in ((fwd, wl), (trans, wl.T)):
            assert g.shape == want.shape
            assert bool(((g - want).abs() <= 2.0 ** -22 * want.abs()).all())
        live += 2 * wl.numel()
    assert int((hi != 0).sum()) <= live
    # lin0's forward block: column 1 holds feature 2, column 4 feature 1
    w0 = blocks[0][0]
    assert torch.equal(hi[: w0.shape[0], 1], tq.split_tf32(w0[:, 2])[0])
    assert torch.equal(hi[: w0.shape[0], 4], tq.split_tf32(w0[:, 1])[0])


def test_permuted_pack_and_tile_give_the_product():
    """The kernel's contraction order: the A fragment's k positions read
    tile features in the pack's column order, so A with its columns in
    TF32_PERM order times a forward block of the pack is A W^T, and the
    same for a transposed block (A g times W): checked with the promoted
    3xTF32 twin against fp64 at ABC width."""
    cfg = tudf.UDFConfig()
    w, _ = packed(cfg)
    pack = tq.pack_weights_tf32(w, cfg)
    lay = tq.query_tf32_layout(cfg)
    whole = pack[:256] + pack[256:]
    wl = tq.unpack_weights(w, torch.zeros(256, 9), cfg)[3][0]  # (193, 256)
    gen = torch.Generator().manual_seed(4)
    for block, k, want_w in (
            (whole[:193, lay["offf"][3]: lay["offf"][3] + 256], 256, wl),
            (whole[:256, lay["ldf"] + lay["offt"][3]:
                   lay["ldf"] + lay["offt"][3] + 224], 224,
             torch.nn.functional.pad(wl.T, (0, 31)))):
        a = torch.randn(64, k, generator=gen)
        cols = (torch.arange(k) & ~7) | torch.as_tensor(tq.TF32_PERM)[
            torch.arange(k) & 7]
        got = tq.tf32x3_matmul(a[:, cols], block.T)
        want = a.double() @ want_w.double().T
        err = (got.double() - want).abs().max() / want.abs().max()
        assert float(err) < 1e-6


def test_promoted_3xtf32_product_is_fp32_accurate():
    """The plain twin of one promoted 3xTF32 product (each operand split
    into rna hi and lo, lo*hi + hi*lo before hi*hi into a fresh accumulator
    for each 32 contraction steps, added to the running sum in fp32)
    against fp64, at a chain product's shape (64 points x 256 features into
    256 outputs): within 1e-6 of the largest entry, as an fp32 matmul is;
    one TF32 pass (hi*hi) is ~1e-4 off and the twin without its lo*hi term
    ~1e-4, so the check sees a dropped pass."""
    gen = torch.Generator().manual_seed(2)
    a = torch.randn(64, 256, generator=gen)
    b = torch.randn(256, 256, generator=gen) / 16
    want = a.double() @ b.double()

    def rel(got):
        return float((got.double() - want).abs().max() / want.abs().max())

    assert rel(tq.tf32x3_matmul(a, b)) < 1e-6
    assert rel(a @ b) < 1e-6
    ah, al = tq.split_tf32(a)
    bh, bl = tq.split_tf32(b)
    assert rel(ah @ bh) > 3e-5
    assert rel(ah @ bl + ah @ bh) > 3e-5


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_cpu_tensors_at_tier_0_reach_the_plain_version(precision):
    """On CPU tensors value_and_grad at "high" and "highest" (kernel tier
    0) is value_and_grad_plain with the same residuals, counts no launch,
    and the extraction's sliced query takes bf16 residuals at "high" and
    fp32 ones at "highest"."""
    cfg = dataclasses.replace(tudf.UDFConfig(**TOY), precision=precision)
    assert tq.kernel_tier(cfg.precision) == 0
    w, b = packed(cfg)
    rng = np.random.default_rng(1)
    x = torch.zeros(8, 256)
    x[:3] = torch.as_tensor(rng.uniform(-1, 1, (3, 256)), dtype=torch.float32)
    before = dict(tq.value_and_grad.tier_launches)
    for f32 in (True, False):
        got = tq.value_and_grad(x, w, b, cfg, f32_residuals=f32)
        want = tq.value_and_grad_plain(x, w, b, cfg, f32_residuals=f32)
        assert all(torch.equal(g, c) for g, c in zip(got, want))
    sliced = tq.value_and_grad_sliced(x, w, b, cfg, cap=128)
    assert all(torch.equal(g, c) for g, c in zip(
        sliced, tq.value_and_grad_plain(x, w, b, cfg, f32_residuals=False)))
    assert tq.bf16_residuals(cfg, False) == (precision == "high")
    assert tq.value_and_grad.tier_launches == before


@pytest.mark.parametrize("name", ["abc", "toy"])
def test_side_residuals_decode_the_kernels_slots(name):
    """side_residuals reads the wgmma query kernels' side scratch back into
    [(out_l, n)] residuals: written here slot by slot as the kernels write
    it (csrc/mlp_wgmma.cuh: side_slot; slot (16 h + j) x 128 + t of a
    tile's layer holds feature 128 h + 8 j + 2 (t % 4) + (e & 1) of point 16
    (t // 32) + (t % 32) // 4 + 8 (e >> 1) in its element e), in fp32 and in
    bf16; unwritten slots (NaN) stay out of the result."""
    cfg = tudf.UDFConfig(**CFGS[name])
    dims = tq.layer_dims(cfg)[:-1]
    n, tiles = 192, 3
    gen = torch.Generator().manual_seed(0)
    want = [torch.rand(o, n, generator=gen) for _, o in dims]
    h, j, t, e = np.meshgrid(np.arange(2), np.arange(16), np.arange(128),
                             np.arange(4), indexing="ij")
    slot = (((h * 16 + j) * 128 + t) * 4 + e).ravel()
    feat = (128 * h + 8 * j + 2 * (t % 4) + (e & 1)).ravel()
    pt = (16 * (t // 32) + (t % 32) // 4 + 8 * (e >> 1)).ravel()
    for dtype in (torch.float32, torch.bfloat16):
        side = torch.full((tiles * len(dims) * 256 * 64,), float("nan"),
                          dtype=dtype)
        for k in range(tiles):
            for l, (_, o) in enumerate(dims):
                live = feat < o
                base = (k * len(dims) + l) * 256 * 64
                side[torch.as_tensor(base + slot[live])] = want[l][
                    torch.as_tensor(feat[live]),
                    torch.as_tensor(64 * k + pt[live])].to(dtype)
        got = tq.side_residuals(side, cfg, n)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert torch.equal(g, w.to(dtype).float())


def test_stored_launch_agrees_with_the_plain_version():
    """The launch of the 3xTF32 query kernel stored in
    tests/fixtures/query_tf32_launch.npz (by scripts/torch_query_tf32_fixture.py
    on an H100, which tests/test_torch_cuda.py holds later builds to bit for
    bit) is of the inputs that script's integer hashes make here: its udf
    and gradient with fp32 residuals lie within 1e-4 of the plain
    version's (the gradient up to the abs head's sign where udf is within
    that of 0), its bf16-residual udf equals its fp32-residual one (the
    residuals touch only the gradient), and the inputs are the same on
    every call."""
    import importlib.util
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "query_tf32_fixture",
        os.path.join(root, "scripts", "torch_query_tf32_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    cfg = dataclasses.replace(tudf.UDFConfig(), precision="high")
    first = fixture.hashed_inputs(cfg)
    assert all(np.array_equal(a, c)
               for a, c in zip(first, fixture.hashed_inputs(cfg)))
    x, w, b = (torch.as_tensor(a) for a in first)
    stored = np.load(os.path.join(root, "tests", "fixtures",
                                  "query_tf32_launch.npz"))
    u, g = tq.value_and_grad_plain(x, w, b, cfg)
    su, sg = (torch.as_tensor(stored[k]) for k in ("udf_f32", "grad_f32"))
    assert torch.equal(su, torch.as_tensor(stored["udf_bf16"]))
    flip = (sg + g[:3]).abs().amax(0) < (sg - g[:3]).abs().amax(0)
    assert not bool((u[flip] > 1e-4 * u.max()).any())
    sg = torch.where(flip, -sg, sg)
    assert float((su - u).abs().max() / u.abs().max()) < 1e-4
    assert float((sg - g[:3]).abs().max() / g[:3].abs().max()) < 1e-4
