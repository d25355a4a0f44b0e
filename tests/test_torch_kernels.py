"""The port's fused field-query kernels (emap_tpu_torch/kernels): their
plain PyTorch versions against the JAX package's Pallas kernels, run in
interpret mode on the CPU, and the autograd.Function that joins them
against JAX's custom_vjp. tests/test_torch_extract.py holds the extraction's
point-level wrappers (query_value, query_value_and_grad).

The CUDA kernels themselves run only on the card: tests/test_torch_cuda.py
holds them against these plain versions there."""

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
N = 256  # two 128-point tiles of the interpret-mode Pallas kernels


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def nets(udf_type="abs", perturb=0.0):
    """(JAX cfg, port cfg, JAX params, port params); `perturb` adds seeded
    noise to every weight so no layer sits at its init pattern."""
    jcfg = judf.UDFConfig(precision="highest", udf_type=udf_type, **TOY)
    tcfg = tudf.UDFConfig(udf_type=udf_type, **TOY)
    jp = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(0),
                                                       jcfg))
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (a + perturb * rng.normal(size=a.shape))
                      .astype(np.float32), jp)
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, tcfg, device="cpu")["udf"]
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def points(seed=1, n=N):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, n), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, n))
    ubar = rng.normal(size=(1, n)).astype(np.float32)
    gbar = np.zeros((8, n), np.float32)
    gbar[:3] = rng.normal(size=(3, n))
    return x, ubar, gbar


def test_pack_weights_match():
    jcfg, tcfg, jp, tp = nets(perturb=0.05)
    wj, bj = jq.pack_weights(jp, jcfg, fuse_pe=True)
    wt, bt = tq.pack_weights(tp, tcfg, fuse_pe=True)
    assert wt.shape == wj.shape and bt.shape == bj.shape
    # the same weight-norm fold in float32
    np.testing.assert_allclose(wt.detach().numpy(), np.asarray(wj),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(bt.detach().numpy(), np.asarray(bj))
    np.testing.assert_array_equal(tq.pe_perm(tcfg), np.asarray(jq._pe_perm(
        jcfg)))


@pytest.mark.parametrize("multires", [10, 6, 4])
def test_blocked_pe_columns_is_the_pe_permutation(multires):
    """fold_weights reorders the encoded-input columns with a reshape and a
    transpose (no index tensor to copy to the card): the same columns as
    indexing by pe_perm, the JAX package's permutation."""
    cfg = tudf.UDFConfig(multires=multires, d_hidden=64)
    w = torch.randn(5, cfg.dims[0], generator=torch.Generator().manual_seed(0))
    perm = np.asarray(jq._pe_perm(judf.UDFConfig(multires=multires,
                                                 d_hidden=64)))
    assert torch.equal(tq.blocked_pe_columns(w, cfg), w[:, perm])


@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_value_and_grad_plain_matches_pallas(udf_type):
    jcfg, tcfg, jp, tp = nets(udf_type, perturb=0.05)
    x, _, _ = points()
    wj, bj = jq.pack_weights(jp, jcfg, fuse_pe=True)
    wt, bt = tq.pack_weights(tp, tcfg, fuse_pe=True)
    uj, gj = jq._pallas_value_and_grad(jnp.asarray(x), wj, bj, jcfg, 128,
                                       True, f32_residuals=True, fuse_pe=True)
    ut, gt = tq.value_and_grad_plain(torch.as_tensor(x), wt.detach(),
                                     bt.detach(), tcfg)
    assert ut.shape == (N,) and gt.shape == (8, N)
    # float32 with sums in another order: measured ~1e-6
    assert max_rel(ut, uj) < 1e-5
    assert max_rel(gt, gj) < 1e-5
    assert float(gt[3:].abs().max()) == 0.0


@pytest.mark.parametrize("udf_type", ["abs", "square", "sdf"])
def test_value_plain_matches_pallas(udf_type):
    """value_plain (raw points, blocked-PE packing) against _pallas_value
    (host-encoded points, interleaved packing), the function kernel #3
    replaces."""
    jcfg, tcfg, jp, tp = nets(udf_type, perturb=0.05)
    x, _, _ = points()
    wj, bj = jq.pack_weights(jp, jcfg)
    uj = jq._pallas_value(jq._encode_host(jnp.asarray(x[:3].T), jcfg), wj, bj,
                          jcfg, 128, True)
    wt, bt = tq.pack_weights(tp, tcfg, fuse_pe=True)
    ut = tq.value_plain(torch.as_tensor(x), wt.detach(), bt.detach(), tcfg)
    assert ut.shape == (N,)
    # float32 with sums in another order: measured ~1e-6
    assert max_rel(ut, uj) < 1e-5
    # the forward of the value-and-gradient version, exactly
    uvg, _ = tq.value_and_grad_plain(torch.as_tensor(x), wt.detach(),
                                     bt.detach(), tcfg)
    assert torch.equal(ut, uvg)


@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_train_bwd_plain_matches_pallas(udf_type):
    jcfg, tcfg, jp, tp = nets(udf_type, perturb=0.05)
    x, ubar, gbar = points()
    wj, bj = jq.pack_weights(jp, jcfg, fuse_pe=True)
    wt, bt = tq.pack_weights(tp, tcfg, fuse_pe=True)
    wbj, bbj = jt._pallas_train_bwd(jnp.asarray(x), wj, bj, jnp.asarray(ubar),
                                    jnp.asarray(gbar), jcfg, 128, True,
                                    fuse_pe=True)
    wbt, bbt = tt.train_bwd_plain(torch.as_tensor(x), wt.detach(),
                                  bt.detach(), torch.as_tensor(ubar),
                                  torch.as_tensor(gbar), tcfg)
    assert wbt.shape == wbj.shape and bbt.shape == bbj.shape
    # float32 sums over 256 points in another order: measured ~2e-6
    assert max_rel(wbt, wbj) < 1e-5
    assert max_rel(bbt, bbj) < 1e-5


def _loss_pair(n=192, seed=1):
    """JAX's kernel and autodiff losses and the port's, on one eikonal-style
    second-order loss (tests/test_kernels_train.py::_loss_pair)."""
    jcfg, tcfg, jp, tp = nets()
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    w_u = rng.normal(size=(n,)).astype(np.float32)
    w_g = rng.normal(size=(n, 3)).astype(np.float32)

    def jmk(qfn):
        def loss(p):
            u, g = qfn(p, jnp.asarray(pts), jcfg)
            return (jnp.sum(w_u * u) + jnp.sum(w_g * g)
                    + 0.1 * jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2))
        return loss

    jker = lambda p, x, c: jt.pallas_udf_train_value_and_gradient(  # noqa: E731
        p, x, c, tile_fwd=128, tile_bwd=128, interpret=True)

    def tloss(p):
        u, g = tt.udf_train_value_and_gradient(p, torch.as_tensor(pts), tcfg)
        return (torch.sum(torch.as_tensor(w_u) * u)
                + torch.sum(torch.as_tensor(w_g) * g)
                + 0.1 * torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2))

    return jmk(jker), jmk(judf.udf_value_and_gradient), tloss, jp, tp


def test_train_query_grads_match_jax_kernel_and_autodiff():
    """(g, v, b) gradients through the autograd.Function (plain versions on
    the CPU) vs JAX's custom_vjp in interpret mode and vs JAX autodiff:
    <= 3e-4 max rel, the bound JAX's own kernel test holds."""
    l_ker, l_xla, tloss, jp, tp = _loss_pair()
    v_k, g_k = jax.jit(jax.value_and_grad(l_ker))(jp)
    g_x = jax.jit(jax.grad(l_xla))(jp)
    leaves = [t.requires_grad_(True) for layer in tp.values()
              for t in layer.values()]
    loss = tloss(tp)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(v_k)) < 1e-4 * (1 + abs(float(v_k)))
    names = [(l, k) for l, layer in tp.items() for k in layer]
    for (l, k), g in zip(names, grads):
        assert max_rel(g, g_k[l][k]) < 3e-4, (l, k)
        assert max_rel(g, g_x[l][k]) < 3e-4, (l, k)


def test_train_query_points_get_no_gradient():
    """The points are detached: their cotangent is zero by design."""
    _, tcfg, _, tp = nets()
    for layer in tp.values():
        for t in layer.values():
            t.requires_grad_(True)
    pts = torch.rand(70, 3, dtype=torch.float32, requires_grad=True,
                     generator=torch.Generator().manual_seed(0))
    u, g = tt.udf_train_value_and_gradient(tp, pts, tcfg)
    assert u.shape == (70,) and g.shape == (70, 3)
    (g.sum() + u.sum()).backward()
    assert pts.grad is None
    assert all(t.grad is not None for layer in tp.values()
               for t in layer.values())


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version and launches nothing."""
    _, tcfg, _, tp = nets()
    x, ubar, gbar = (torch.as_tensor(a) for a in points(n=128))
    w, b = (t.detach() for t in tq.pack_weights(tp, tcfg))
    before = (tq.value_and_grad.launches, tt.train_bwd.launches,
              tq.value.launches)
    assert torch.equal(tq.value(x, w, b, tcfg), tq.value_plain(x, w, b, tcfg))
    u, g = tq.value_and_grad(x, w, b, tcfg)
    up, gp = tq.value_and_grad_plain(x, w, b, tcfg)
    assert torch.equal(u, up) and torch.equal(g, gp)
    wb, bb = tt.train_bwd(x, w, b, ubar, gbar, tcfg)
    wp, bp = tt.train_bwd_plain(x, w, b, ubar, gbar, tcfg)
    assert torch.equal(wb, wp) and torch.equal(bb, bp)
    assert (tq.value_and_grad.launches, tt.train_bwd.launches,
            tq.value.launches) == before


def test_kernel_operands_are_checked():
    _, tcfg, _, tp = nets()
    w, b = (t.detach() for t in tq.pack_weights(tp, tcfg))
    x = torch.zeros(8, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tq.check_operands(tcfg, (x, w, b))
    with pytest.raises(ValueError, match="multiple"):
        tq.check_operands(tcfg, (torch.zeros(8, 100), w, b))
    with pytest.raises(ValueError, match="multires"):
        tq.check_kernel_cfg(dataclasses.replace(tcfg, multires=0))
    with pytest.raises(ValueError, match="256"):
        tq.check_kernel_cfg(dataclasses.replace(tcfg, d_hidden=320))
    with pytest.raises(ValueError, match="multiple of 4"):
        tq.check_kernel_cfg(dataclasses.replace(tcfg, d_hidden=30))


def test_layout_and_work_at_abc_width():
    """The layout the CUDA kernels parse, and the work they are bounded by,
    at ABC width: 9 linears 64->256, 256->256 x2, 256->193, 256->256 x4,
    256->1 over f32 (256, 2112) packed weights."""
    cfg = tudf.UDFConfig()
    dims = tq.layer_dims(cfg)
    assert dims == [(64, 256), (256, 256), (256, 256), (256, 193)] + [
        (256, 256)] * 4 + [(256, 1)]
    lay = tq.kernel_layout(cfg)
    assert list(lay[:7]) == [9, 63, 64, 10, 0, 2112, 256]
    assert list(lay[7 + 4 * 4: 7 + 4 * 5]) == [256, 256, 832, 1]  # the skip
    assert tq.query_flops(cfg) == 4 * sum(i * o for _, i, o in
                                          cfg.layer_shapes()) == 1_836_032
    assert tt.train_bwd_flops(cfg) == 5_443_584
    assert tq.value_flops(cfg) == 918_016
    # the slicing cap keeps a training step (1,024 rays x 114 samples) one
    # launch of the value-and-gradient kernel
    assert tq.SLICE_CAP >= 1024 * 114 and tq.SLICE_CAP % tq.POINT_TILE == 0
