"""The port's config, positional encoding, UDF field and scalar networks
(emap_tpu_torch) against the JAX package (emap_tpu) on the CPU.

Inputs come from numpy with a seed and go to both packages; the JAX side
runs at precision "highest" (full float32 matmuls), and weights cross over
through the port's checkpoint converter."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu import config as jconfig
from emap_tpu.fields import embedder as jemb
from emap_tpu.fields import scalars as jscal
from emap_tpu.fields import udf as judf
from emap_tpu_torch import config as tconfig
from emap_tpu_torch.ckpt.convert import check_params, params_from_numpy
from emap_tpu_torch.fields import embedder as temb
from emap_tpu_torch.fields import scalars as tscal
from emap_tpu_torch.fields import udf as tudf

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "confs")
TOY = dict(d_hidden=64, n_layers=8, multires=4)


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def toy_nets(udf_type="abs", seed=0):
    """(JAX cfg, port cfg, JAX params, port params) with the same weights."""
    jcfg = judf.UDFConfig(precision="highest", udf_type=udf_type, **TOY)
    tcfg = tudf.UDFConfig(udf_type=udf_type, **TOY)
    jp = judf.init_udf_params(jax.random.key(seed), jcfg)
    tp = params_from_numpy({"udf": jax.tree.map(np.asarray, jp),
                            "variance": {"variance": np.zeros(1),
                                         "second_variance": np.zeros(1)},
                            "beta": {"beta": np.zeros(1), "gamma": np.zeros(1),
                                     "zeta": np.zeros(1)}},
                           tcfg, device="cpu")["udf"]
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("name", ["ABC.conf", "DTU.conf", "Replica.conf"])
def test_config_parses_shipped_confs(name):
    path = os.path.join(CONF_DIR, name)
    tconf = tconfig.parse_file(path)
    assert tconf.as_dict() == jconfig.parse_file(path).as_dict()
    # the snapshot the runner writes parses back to the same tree
    assert tconfig.parse_string(tconf.to_hocon()).as_dict() == tconf.as_dict()


@pytest.mark.parametrize("name", ["ABC.conf", "DTU.conf", "Replica.conf"])
def test_udf_config_matches(name):
    """Every UDFConfig field, its default and its conf reading."""
    jf = {f.name: f.default for f in dataclasses.fields(judf.UDFConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tudf.UDFConfig)}
    assert tf == jf
    path = os.path.join(CONF_DIR, name)
    jc = judf.UDFConfig.from_conf(
        jconfig.parse_file(path).get_config("model.udf_network"))
    tc = tudf.UDFConfig.from_conf(
        tconfig.parse_file(path).get_config("model.udf_network"))
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.dims == jc.dims and list(tc.layer_shapes()) == list(
        jc.layer_shapes())


@pytest.mark.parametrize("multires", [0, 4, 10])
def test_positional_encoding(multires):
    x = np.random.default_rng(3).uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    ref = np.asarray(jemb.positional_encoding(jnp.asarray(x), multires))
    got = temb.positional_encoding(torch.as_tensor(x), multires).numpy()
    assert got.shape == ref.shape == (5, 7, temb.pe_dim(multires))
    # sin/cos of the same float32 arguments: a few ulp
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def test_init_structure():
    """Geometric init: the JAX package's shapes, zeroed PE columns at lin0
    and the skip layer, the last layer's bias, g = ||v||_row."""
    cfg = tudf.UDFConfig(**TOY)
    jcfg = judf.UDFConfig(**TOY)
    tp = tudf.init_udf_params(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    jp = judf.init_udf_params(jax.random.key(0), jcfg)
    assert set(tp) == set(jp)
    for name, layer in tp.items():
        assert {k: tuple(v.shape) for k, v in layer.items()} == {
            k: tuple(v.shape) for k, v in jp[name].items()}
        np.testing.assert_allclose(
            layer["g"].numpy(), torch.linalg.norm(layer["v"], dim=1).numpy(),
            rtol=1e-6)
    d0 = cfg.dims[0]
    assert float(tp["lin0"]["v"][:, 3:].abs().max()) == 0.0
    assert float(tp["lin4"]["v"][:, -(d0 - 3):].abs().max()) == 0.0
    assert float(tp["lin4"]["v"][:, :-(d0 - 3)].abs().max()) > 0.0
    np.testing.assert_array_equal(tp["lin8"]["b"].numpy(), [-cfg.bias])
    check_params({"udf": tp, "variance": {"variance": 0, "second_variance": 0},
                  "beta": {"beta": 0, "gamma": 0, "zeta": 0}}, cfg)


@pytest.mark.parametrize("udf_type", ["abs", "square", "sdf"])
def test_udf_value_and_gradient_match(udf_type):
    jcfg, tcfg, jp, tp = toy_nets(udf_type)
    pts = np.random.default_rng(1).uniform(-1, 1, (192, 3)).astype(np.float32)
    ju, jg = jax.jit(judf.udf_value_and_gradient, static_argnums=2)(
        jp, jnp.asarray(pts), jcfg)
    tu, tg = tudf.udf_value_and_gradient(tp, torch.as_tensor(pts), tcfg)
    # float32 with the same operations in another summation order
    assert max_rel(tu.detach(), ju) < 1e-5
    assert max_rel(tg.detach(), jg) < 1e-5
    np.testing.assert_allclose(
        tudf.udf_value(tp, torch.as_tensor(pts), tcfg).detach().numpy(),
        np.asarray(judf.udf_value(jp, jnp.asarray(pts), jcfg)),
        rtol=0, atol=1e-5 * float(np.abs(np.asarray(ju)).max()))


def test_second_order_param_gradient_matches():
    """Param-gradient of a loss on the spatial gradient (double backward
    through torch.autograd.grad(create_graph=True)) vs jax.grad."""
    jcfg, tcfg, jp, tp = toy_nets()
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (192, 3)).astype(np.float32)
    w_u = rng.normal(size=192).astype(np.float32)
    w_g = rng.normal(size=(192, 3)).astype(np.float32)

    def jloss(p):
        u, g = judf.udf_value_and_gradient(p, jnp.asarray(pts), jcfg)
        return (jnp.sum(w_u * u) + jnp.sum(w_g * g)
                + 0.1 * jnp.mean((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2))

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(jp)
    leaves = [t.requires_grad_(True) for layer in tp.values()
              for t in layer.values()]
    u, g = tudf.udf_value_and_gradient(tp, torch.as_tensor(pts), tcfg)
    loss = (torch.sum(torch.as_tensor(w_u) * u)
            + torch.sum(torch.as_tensor(w_g) * g)
            + 0.1 * torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2))
    tgrads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    names = [(l, k) for l, layer in tp.items() for k in layer]
    for (l, k), tgr in zip(names, tgrads):
        # second-order float32 sums in another order
        assert max_rel(tgr, jgrads[l][k]) < 1e-4, (l, k)


@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_udf_gradient_matches(udf_type):
    """udf_gradient against emap_tpu.fields.udf_gradient (grad of a sum):
    rtol 1e-5, as the JAX package holds its fused pair to it."""
    jcfg, tcfg, jp, tp = toy_nets(udf_type)
    pts = np.random.default_rng(3).uniform(-1, 1, (192, 3)).astype(np.float32)
    jg = jax.jit(judf.udf_gradient, static_argnums=2)(jp, jnp.asarray(pts),
                                                      jcfg)
    tg = tudf.udf_gradient(tp, torch.as_tensor(pts), tcfg)
    assert tg.shape == (192, 3)
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jg)).max()))
    # the same graph as udf_value_and_gradient's gradient, so the same bits
    _, tg2 = tudf.udf_value_and_gradient(tp, torch.as_tensor(pts), tcfg)
    assert torch.equal(tg, tg2)


def test_udf_gradient_eikonal_param_gradient_matches():
    """The eikonal loss of tests/test_fields.py's double-backprop test,
    differentiated w.r.t. the parameters through udf_gradient, against
    jax.grad of the same: max relative error < 1e-4 a leaf."""
    jcfg, tcfg, jp, tp = toy_nets()
    pts = np.random.default_rng(4).uniform(-0.5, 0.5, (64, 3)).astype(
        np.float32)

    def jeikonal(p):
        g = judf.udf_gradient(p, jnp.asarray(pts), jcfg)
        return ((jnp.linalg.norm(g, axis=-1) - 1.0) ** 2).mean()

    jval, jgrads = jax.jit(jax.value_and_grad(jeikonal))(jp)
    leaves = [t.requires_grad_(True) for layer in tp.values()
              for t in layer.values()]
    g = tudf.udf_gradient(tp, torch.as_tensor(pts), tcfg)
    loss = ((torch.linalg.norm(g, dim=-1) - 1.0) ** 2).mean()
    tgrads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jval), rel=1e-5)
    names = [(l, k) for l, layer in tp.items() for k in layer]
    for (l, k), tgr in zip(names, tgrads):
        assert torch.isfinite(tgr).all(), (l, k)
        assert max_rel(tgr, jgrads[l][k]) < 1e-4, (l, k)


def test_scalars_match():
    var = {"variance": np.array([0.3], np.float32),
           "second_variance": np.array([0.3], np.float32)}
    beta = {"beta": np.array([0.5], np.float32),
            "gamma": np.array([0.3], np.float32),
            "zeta": np.array([-0.2], np.float32)}
    tvar = {k: torch.as_tensor(v) for k, v in var.items()}
    tbeta = {k: torch.as_tensor(v) for k, v in beta.items()}
    np.testing.assert_allclose(
        tscal.inv_s_value(tvar).numpy(),
        np.asarray(jscal.inv_s_value({k: jnp.asarray(v)
                                      for k, v in var.items()})), rtol=1e-6)
    for beta_min in (0.00005, 0.01):
        got = tscal.beta_gamma_zeta(tbeta, beta_min)
        want = jscal.beta_gamma_zeta({k: jnp.asarray(v)
                                      for k, v in beta.items()}, beta_min)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    init = tscal.init_variance_params(0.3, device="cpu")
    assert set(init) == set(jscal.init_variance_params(0.3))
    assert set(tscal.init_beta_params(device="cpu")) == set(
        jscal.init_beta_params())


def test_params_converter_refuses_other_widths():
    _, _, jp, _ = toy_nets()
    tree = {"udf": jax.tree.map(np.asarray, jp),
            "variance": {"variance": np.zeros(1),
                         "second_variance": np.zeros(1)},
            "beta": {"beta": np.zeros(1), "gamma": np.zeros(1),
                     "zeta": np.zeros(1)}}
    with pytest.raises(ValueError, match="lin0"):
        params_from_numpy(tree, tudf.UDFConfig(d_hidden=48, n_layers=8,
                                               multires=5), device="cpu")
