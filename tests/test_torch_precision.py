"""The JAX package's matmul tiers in the port (fields/udf.py::TIERS): the
conf keys `precision`, `bwd_precision`, `field_precision` and
`sampler_precision` select, site by site, what they select in emap_tpu.

"default" is one bf16 pass. The JAX package's Pallas kernels run it in
interpret mode on the CPU exactly as on the TPU (`_kernel_dot` casts both
operands to bf16), so each kernel's plain version is held against them at
"default" and at "high", and at "default" its mean error against JAX's
"highest" must exceed its mean error against JAX's "default" by a stated
factor. XLA's dots on the
CPU ignore Precision.DEFAULT and compute in fp32, so the up-sampler's
tier, an XLA dot in the JAX package, is held to its definition, and the
training step's JAX side is given the TPU's DEFAULT for its up-sampler
(`tpu_default_udf_value`).

Two bf16 computations of one function differ where fp32 roundoff in another
sum order flips a bf16 rounding (one bf16 ulp, 2^-8 to 2^-7 of the operand):
the flips are few but move single outputs by ~1e-3 of their block's
largest. The tolerances at "default" are stated with that measurement
beside them."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu import config as jconfig
from emap_tpu.data import dataset as jds
from emap_tpu.fields import udf as judf
from emap_tpu.fields.embedder import positional_encoding
from emap_tpu.kernels import mlp_query as jq
from emap_tpu.kernels import mlp_train as jt
from emap_tpu.render import renderer as jr
from emap_tpu.train import runner as jrunner
from emap_tpu.train import state as jstate
from emap_tpu.train import step as jstep
from emap_tpu_torch import config
from emap_tpu_torch.ckpt import convert
from emap_tpu_torch.ckpt.convert import params_from_numpy
from emap_tpu_torch.data import make_synthetic_scene
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.kernels import mlp_query as tq
from emap_tpu_torch.kernels import mlp_train as tt
from emap_tpu_torch.render import renderer as tr
from emap_tpu_torch.train import step as tstep
from emap_tpu_torch.train.runner import Runner

TOY = dict(d_hidden=64, n_layers=8, multires=6)
N = 256  # two 128-point tiles of the interpret-mode Pallas kernels


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def mean_rel(a, b) -> float:
    """Mean error over the largest |b|: where the max is set by a few
    flipped roundings, the mean tells a tier's error from the flips."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).mean() / (np.abs(b).max() + 1e-30))


def nets(udf_type="abs", perturb=0.05):
    """(JAX params, port params, port cfg) of one toy net with seeded noise
    on every weight; JAX configs are made per tier by the tests."""
    jcfg = judf.UDFConfig(udf_type=udf_type, **TOY)
    tcfg = tudf.UDFConfig(udf_type=udf_type, **TOY)
    jp = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(0),
                                                       jcfg))
    rng = np.random.default_rng(7)
    jp = jax.tree.map(lambda a: (a + perturb * rng.normal(size=a.shape))
                      .astype(np.float32), jp)
    zeros = {"variance": {"variance": 0.0, "second_variance": 0.0},
             "beta": {"beta": 0.0, "gamma": 0.0, "zeta": 0.0}}
    tp = params_from_numpy({"udf": jp, **zeros}, tcfg, device="cpu")["udf"]
    return jax.tree.map(jnp.asarray, jp), tp, tcfg


def points(seed=1, n=N):
    rng = np.random.default_rng(seed)
    x = np.zeros((8, n), np.float32)
    x[:3] = rng.uniform(-1, 1, (3, n))
    ubar = rng.normal(size=(1, n)).astype(np.float32)
    gbar = np.zeros((8, n), np.float32)
    gbar[:3] = rng.normal(size=(3, n))
    return x, ubar, gbar


def jcfg_at(tier, bwd="", udf_type="abs"):
    return judf.UDFConfig(precision=tier, bwd_precision=bwd,
                          udf_type=udf_type, **TOY)


def packed(tp, tcfg):
    return tuple(t.detach() for t in tq.pack_weights(tp, tcfg, fuse_pe=True))


# Training query #1a, port at a tier against the Pallas kernel at the same
# tier, max rel (udf, grad). "default": measured udf 4.9e-4 (abs) / 4.7e-4
# (square), grad 5.0e-3 / 2.1e-3. "high": the JAX package's 3-pass bf16
# emulation of fp32 against the port's fp32, measured udf 6.9e-6 / 9.0e-6,
# grad 4.1e-5 / 3.7e-5.
QUERY_RTOL = {"default": (2e-3, 1.5e-2), "high": (1e-4, 2e-4)}
# At "default": mean error against JAX "highest" over mean error against JAX
# "default", measured 225x / 245x (udf), 91x / 157x (grad); 225x / 245x for
# #3, 155x for #1b's udf, 640x for apply_udf.
DISCRIMINATION = 10.0


@pytest.mark.parametrize("tier", ["default", "high"])
@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_value_and_grad_tiers_match_pallas(tier, udf_type):
    jp, tp, tcfg0 = nets(udf_type)
    tcfg = dataclasses.replace(tcfg0, precision=tier)
    x, _, _ = points()
    ut, gt = tq.value_and_grad_plain(torch.as_tensor(x), *packed(tp, tcfg),
                                     tcfg)

    def jax_at(t):
        jcfg = jcfg_at(t, udf_type=udf_type)
        wj, bj = jq.pack_weights(jp, jcfg, fuse_pe=True)
        return jq._pallas_value_and_grad(jnp.asarray(x), wj, bj, jcfg, 128,
                                         True, f32_residuals=True,
                                         fuse_pe=True)

    uj, gj = jax_at(tier)
    u_tol, g_tol = QUERY_RTOL[tier]
    assert max_rel(ut, uj) < u_tol
    assert max_rel(gt, gj) < g_tol
    if tier == "default":
        uh, gh = jax_at("highest")
        assert mean_rel(ut, uh) > DISCRIMINATION * mean_rel(ut, uj)
        assert mean_rel(gt, gh) > DISCRIMINATION * mean_rel(gt, gj)


# Grid value #3: the forward alone, so the same bounds as #1a's udf
# (measured 4.9e-4 / 4.7e-4 at "default", 6.9e-6 / 9.0e-6 at "high").
@pytest.mark.parametrize("tier", ["default", "high"])
@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_value_tiers_match_pallas(tier, udf_type):
    jp, tp, tcfg0 = nets(udf_type)
    tcfg = dataclasses.replace(tcfg0, precision=tier)
    x, _, _ = points()
    ut = tq.value_plain(torch.as_tensor(x), *packed(tp, tcfg), tcfg)

    def jax_at(t):
        jcfg = jcfg_at(t, udf_type=udf_type)
        wj, bj = jq.pack_weights(jp, jcfg)
        return jq._pallas_value(jq._encode_host(jnp.asarray(x[:3].T), jcfg),
                                wj, bj, jcfg, 128, True)

    assert max_rel(ut, jax_at(tier)) < QUERY_RTOL[tier][0]
    if tier == "default":
        assert mean_rel(ut, jax_at("highest")) > DISCRIMINATION * mean_rel(
            ut, jax_at("default"))


# Extraction query #1b (pallas_udf_value_and_grad: the PE encoded by XLA
# outside the kernel, which moves the encoded rows by an ulp and so flips
# more roundings; the sigmoid residuals rounded to bf16 on both fast tiers,
# as the port's query_value_and_grad rounds them, f32_residuals=False).
# Measured max rel (abs head, points of seeds 3 / 4 / 5): "default" udf
# 1.7e-3 / 6.0e-4 / 4.3e-4, grad 1.9e-3 / 4.1e-3 / 3.2e-3; "high" udf
# 8.9e-6 / 7.1e-6 / 7.7e-6, grad 5.2e-4 / 4.8e-4 / 5.8e-4 (bf16 roundings
# of sigmoids an ulp apart that land on either side of a rounding
# boundary); the square head within 1.1x of those. With fp32 residuals the
# grad was 5.4e-3 ("default") and 1.4e-3 ("high"). The grad bounds are
# twice the largest measured. #1b's gradient at "default" has a mean error
# against JAX's "default" of 1.3e-5, 258x under the one against
# "highest" (3.4x with fp32 residuals): held to DISCRIMINATION.
EXTRACT_RTOL = {"default": (5e-3, 8e-3), "high": (1e-4, 1.2e-3)}
EXTRACT_GRAD_DISCRIMINATION = DISCRIMINATION
# At "high", the port's gradient with bf16 residuals against JAX's over
# the one with fp32 residuals, mean error: measured 2.2e-5 against 2.5e-4
# (11.6x; 11.8x, 12.2x at seeds 4, 5).
RESIDUAL_DISCRIMINATION = 4.0


@pytest.mark.parametrize("tier", ["default", "high"])
def test_extraction_query_tiers_match_pallas(tier):
    jp, tp, tcfg0 = nets()
    tcfg = dataclasses.replace(tcfg0, precision=tier)
    pts = np.random.default_rng(3).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    ut, gt = tq.query_value_and_grad(tp, torch.as_tensor(pts), tcfg)

    def jax_at(t):
        return jq.pallas_udf_value_and_grad(jp, jnp.asarray(pts), jcfg_at(t),
                                            tile=128, interpret=True)

    uj, gj = jax_at(tier)
    u_tol, g_tol = EXTRACT_RTOL[tier]
    assert max_rel(ut, uj) < u_tol
    assert max_rel(gt, gj) < g_tol
    if tier == "default":
        uh, gh = jax_at("highest")
        assert mean_rel(ut, uh) > DISCRIMINATION * mean_rel(ut, uj)
        assert mean_rel(gt, gh) > EXTRACT_GRAD_DISCRIMINATION * mean_rel(gt,
                                                                         gj)


@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_extraction_query_residuals_are_jaxs(udf_type):
    """The extraction query's bf16 sigmoid residuals are what brings its
    gradient to JAX's pallas_udf_value_and_grad at "high": the port's
    gradient with them sits RESIDUAL_DISCRIMINATION times nearer JAX's, by
    mean error, than with fp32 residuals."""
    jp, tp, tcfg0 = nets(udf_type)
    tcfg = dataclasses.replace(tcfg0, precision="high")
    pts = np.random.default_rng(3).uniform(-1, 1, (300, 3)).astype(
        np.float32)
    _, gj = jq.pallas_udf_value_and_grad(jp, jnp.asarray(pts), jcfg_at(
        "high", udf_type=udf_type), tile=128, interpret=True)
    _, g16 = tq.query_value_and_grad(tp, torch.as_tensor(pts), tcfg)
    _, g32 = tq.query_value_and_grad(tp, torch.as_tensor(pts), tcfg,
                                     f32_residuals=True)
    assert max_rel(g16, gj) < EXTRACT_RTOL["high"][1]
    assert RESIDUAL_DISCRIMINATION * mean_rel(g16, gj) < mean_rel(g32, gj)


@pytest.mark.parametrize("tier", ["default", "high", "highest"])
def test_training_query_keeps_fp32_residuals(tier):
    """The training forward's query (value_and_grad, as TrainQuery calls
    it) keeps fp32 residuals at every tier, bit for bit the same as with
    f32_residuals=True; the extraction's bf16 residuals change the gradient
    at "default" and "high" and, as in the JAX package, not at
    "highest"."""
    _, tp, tcfg0 = nets()
    tcfg = dataclasses.replace(tcfg0, precision=tier)
    x = torch.as_tensor(points()[0])
    w, b = packed(tp, tcfg)
    train = tq.value_and_grad(x, w, b, tcfg)
    f32 = tq.value_and_grad_plain(x, w, b, tcfg, f32_residuals=True)
    bf16 = tq.value_and_grad_plain(x, w, b, tcfg, f32_residuals=False)
    assert all(torch.equal(a, c) for a, c in zip(train, f32))
    assert torch.equal(bf16[0], f32[0])
    assert torch.equal(bf16[1], f32[1]) == (tier == "highest")


# Backward #2 at (primal, adjoint) tier pairs, W-bar and b-bar as wholes.
# Measured max rel against the Pallas kernel at the same pair (abs /
# square): (default, default) 1.9e-3 / 1.6e-3, (high, default) 2.7e-3 /
# 2.5e-3, (default, high) 1.1e-3 / 8.6e-4. W-bar's mean error against JAX
# "highest" over the one against the same pair: 41x / 48x, 2.6x / 2.6x and
# 50x / 62x. With an fp32 primal and a bf16 adjoint the tier's own error is
# smallest, so that pair is held to a factor of 1.5.
BWD_RTOL = 8e-3
BWD_DISCRIMINATION = {("default", "default"): 10.0, ("high", "default"): 1.5,
                      ("default", "high"): 10.0}


@pytest.mark.parametrize("pair", sorted(BWD_DISCRIMINATION))
@pytest.mark.parametrize("udf_type", ["abs", "square"])
def test_train_bwd_tiers_match_pallas(pair, udf_type):
    primal, adjoint = pair
    jp, tp, tcfg0 = nets(udf_type)
    # bwd_precision "" where it equals the primal tier: the inheriting conf
    bwd = "" if adjoint == primal else adjoint
    tcfg = dataclasses.replace(tcfg0, precision=primal, bwd_precision=bwd)
    assert tudf.adjoint_tier(tcfg) == adjoint
    x, ubar, gbar = points()
    w, b = packed(tp, tcfg)
    wbt, bbt = tt.train_bwd_plain(torch.as_tensor(x), w, b,
                                  torch.as_tensor(ubar),
                                  torch.as_tensor(gbar), tcfg)

    def jax_at(p, a):
        jcfg = jcfg_at(p, a, udf_type)
        wj, bj = jq.pack_weights(jp, jcfg, fuse_pe=True)
        return jt._pallas_train_bwd(jnp.asarray(x), wj, bj,
                                    jnp.asarray(ubar), jnp.asarray(gbar),
                                    jcfg, 128, True, fuse_pe=True)

    wbj, bbj = jax_at(primal, bwd)
    assert max_rel(wbt, wbj) < BWD_RTOL
    assert max_rel(bbt, bbj) < BWD_RTOL
    wbh, _ = jax_at("highest", "")
    assert mean_rel(wbt, wbh) > BWD_DISCRIMINATION[pair] * mean_rel(wbt,
                                                                     wbj)


def test_tier_linear_is_its_definition():
    """One product at each tier against float64 arithmetic on the operands
    the tier takes: "default" rounds both to bf16 (numpy's ml_dtypes
    conversion, to nearest even), "high" and "highest" take them as they
    are; fp32 sums of 100 exact products stay within 1e-6 of the largest.
    The backward's products keep the tier: the input's gradient is
    bf16(g) @ bf16(w) at "default"."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 100)).astype(np.float32)
    w = rng.normal(size=(30, 100)).astype(np.float32)
    g = rng.normal(size=(50, 30)).astype(np.float32)

    def bf16(a):
        return a.astype(jnp.bfloat16).astype(np.float64)

    exact = x.astype(np.float64) @ w.astype(np.float64).T
    rounded = bf16(x) @ bf16(w).T
    for tier in tudf.TIERS:
        xt = torch.as_tensor(x).requires_grad_(True)
        y = tudf.tier_linear(xt, torch.as_tensor(w), tier)
        (gx,) = torch.autograd.grad(y, xt, torch.as_tensor(g))
        want = rounded if tier == "default" else exact
        want_gx = (bf16(g) @ bf16(w) if tier == "default"
                   else g.astype(np.float64) @ w.astype(np.float64))
        assert y.dtype == torch.float32
        assert max_rel(y.detach(), want) < 1e-6, tier
        assert max_rel(gx, want_gx) < 1e-6, tier
    # the rounding is there: bf16 keeps 8 significant bits
    assert max_rel(rounded, exact) > 1e-3


def numpy_udf(jp, pts, cfg, tier):
    """The UDF network in float64 numpy with every product's operands as
    the tier takes them (bf16-rounded at "default")."""
    def op(a):
        a = np.asarray(a, np.float32)
        return (a.astype(jnp.bfloat16) if tier == "default" else a).astype(
            np.float64)

    inputs = np.asarray(positional_encoding(jnp.asarray(pts * cfg.scale),
                                            cfg.multires), np.float64)
    x = inputs
    n_linear = len(cfg.dims) - 1
    for l in range(n_linear):
        if l in cfg.skip_in:
            x = np.concatenate([x, inputs], axis=-1) / np.sqrt(2.0)
        w = np.asarray(judf._effective_weight(jp[f"lin{l}"]), np.float64)
        x = op(x) @ op(w).T + np.asarray(jp[f"lin{l}"]["b"], np.float64)
        if l < n_linear - 1:
            x = np.logaddexp(0.0, 100.0 * x) / 100.0
    return np.abs(x[:, 0]) / cfg.scale


# apply_udf at each tier against numpy_udf: "high" and "highest" are fp32
# (measured 3.8e-7); at "default" the two round the activations of a float32
# and a float64 chain, which flips a few roundings (measured 6.0e-4; the
# mean error against the unrounded float64 chain is 640x the one against the
# rounded).
@pytest.mark.parametrize("tier", tudf.TIERS)
def test_apply_udf_tiers_follow_their_definition(tier):
    jp, tp, tcfg0 = nets()
    tcfg = dataclasses.replace(tcfg0, precision=tier)
    pts = np.random.default_rng(4).uniform(-1, 1, (400, 3)).astype(np.float32)
    got = tudf.udf_value(tp, torch.as_tensor(pts), tcfg).detach()
    want = numpy_udf(jp, pts, tcfg, tier)
    if tier == "default":
        assert max_rel(got, want) < 2e-3
        assert mean_rel(got, numpy_udf(jp, pts, tcfg, "high")) > (
            DISCRIMINATION * mean_rel(got, want))
    else:
        assert max_rel(got, want) < 1e-5


def test_autograd_route_at_the_bf16_tier_matches_the_kernels():
    """pallas_train = "off" at the bf16 tier (apply_udf's products and its
    backward's, to second order) against the fused query's plain versions
    at the same tier, through a second-order loss: the same rounded
    operands, flips apart (measured 4.4e-4 max rel in the worst leaf,
    against up to 2.3e-1 from the fp32 kernels)."""
    _, tp, tcfg0 = nets()
    rng = np.random.default_rng(1)
    pts = torch.as_tensor(rng.uniform(-1, 1, (192, 3)).astype(np.float32))
    w_u = torch.as_tensor(rng.normal(size=(192,)).astype(np.float32))
    w_g = torch.as_tensor(rng.normal(size=(192, 3)).astype(np.float32))
    leaves = [t.requires_grad_(True) for layer in tp.values()
              for t in layer.values()]

    def grads(cfg):
        u, g = tr.query_field({"udf": tp}, pts, cfg)
        loss = (torch.sum(w_u * u) + torch.sum(w_g * g)
                + 0.1 * torch.mean((torch.linalg.norm(g, dim=-1) - 1.0) ** 2))
        return torch.autograd.grad(loss, leaves)

    at = dataclasses.replace(tcfg0, precision="default")
    kern = grads(at)
    auto = grads(dataclasses.replace(at, pallas_train="off"))
    fp32 = grads(tcfg0)
    worst = max(max_rel(a, k) for a, k in zip(auto, kern))
    assert worst < 2e-3
    assert max(max_rel(f, k) for f, k in zip(fp32, kern)) > 10 * worst


def test_unknown_tier_names_raise():
    """The three tier names and nothing else, with "" where a key inherits;
    the JAX package refuses the same names where it reads them."""
    for bad in ("bf16", "DEFAULT", "f32", ""):
        with pytest.raises(ValueError, match="precision"):
            tudf.UDFConfig(precision=bad)
        with pytest.raises(ValueError, match="sampler_precision"):
            tr.RenderConfig(sampler_precision=bad)
        with pytest.raises(ValueError):
            tq.kernel_tier(bad)
        with pytest.raises(ValueError):
            jax.lax.Precision(bad)
    for bad in ("bf16", "HIGH"):
        with pytest.raises(ValueError, match="bwd_precision"):
            tudf.UDFConfig(bwd_precision=bad)
        with pytest.raises(ValueError, match="field_precision"):
            tr.RenderConfig(field_precision=bad)
    # "" inherits for these two
    assert tudf.UDFConfig(bwd_precision="").bwd_precision == ""
    assert tr.RenderConfig(field_precision="").field_precision == ""
    # the kernels' tier codes: one bf16 pass, or fp32 by 3xTF32
    assert [tq.kernel_tier(t) for t in tudf.TIERS] == [1, 0, 0]


# confs and the keys each pins (model.udf_network.* / model.udf_renderer.*)
TIER_CONFS = {
    "none pinned": {},
    "precision pinned": {"udf_network.precision": "highest"},
    "precision and field_precision pinned": {
        "udf_network.precision": "highest",
        "udf_renderer.field_precision": "default"},
    "precision pinned to default": {"udf_network.precision": "default"},
    "bwd_precision pinned": {"udf_network.bwd_precision": "high"},
    "sampler_precision pinned": {"udf_renderer.sampler_precision": "highest"},
}


@pytest.fixture(scope="module")
def tier_scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tiers")
    data_dir = str(tmp / "data")
    make_synthetic_scene(data_dir, scan="cube000", n_views=2, H=16, W=16)
    return tmp, data_dir


def jax_resolved(runner, monkeypatch) -> dict:
    """The tiers the JAX runner's configs resolve to in the JAX package's
    own code: render() on one ray with the field query and the up-sampler's
    udf_value recording the UDFConfig they are handed; the adjoint tier is
    _train_bwd_math's `bwd_precision or precision` of the field's config,
    the route _use_pallas_train's on a TPU, extraction the runner's ucfg
    (Runner.extract_edge hands it to extract_pointcloud)."""
    seen = {}

    def field(params, pts, udf_cfg, mesh=None, axis="data"):
        seen["field"] = udf_cfg
        return jnp.zeros(pts.shape[0]), jnp.zeros((pts.shape[0], 3))

    def sampler(params, pts, cfg):
        seen["sampler"] = cfg
        return jnp.zeros(pts.shape[:-1])

    monkeypatch.setattr(jr, "_query_field", field)
    monkeypatch.setattr(jr, "udf_value", sampler)
    ray = jnp.asarray([[0.0, 0.0, -2.0]]), jnp.asarray([[0.0, 0.0, 1.0]])
    jr.render(runner.state.params, *ray, 0.05, 4.5, jnp.ones((1, 1)),
              jax.random.key(0), runner.rcfg, runner.ucfg)
    monkeypatch.setattr(jq, "pallas_available", lambda: True)
    f = seen["field"]
    return {"field": f.precision, "adjoint": f.bwd_precision or f.precision,
            "sampler": seen["sampler"].precision,
            "extraction": runner.ucfg.precision,
            "route": "kernels" if jr._use_pallas_train(f) else "autograd"}


@pytest.mark.parametrize("case", sorted(TIER_CONFS))
def test_resolved_tiers_match_the_jax_runner(case, tier_scene, monkeypatch):
    """Each conf of the table through both packages' Runner: the tiers of
    the training field query (primal, adjoint), the up-sampler and the
    extraction, and the training query's route, are emap_tpu's."""
    tmp, data_dir = tier_scene
    text = open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "confs", "ABC.conf")).read()
    confs = []
    for parse in (config.parse_string, jconfig.parse_string):
        conf = parse(text)
        conf["general.base_exp_dir"] = str(tmp / case.replace(" ", "_"))
        conf["general.recording"] = []
        conf["dataset.data_dir"] = data_dir
        conf["dataset.scan"] = "cube000"
        for k, v in dict(TOY, n_layers=4, skip_in=[2]).items():
            conf[f"model.udf_network.{k}"] = v
        for k, v in TIER_CONFS[case].items():
            conf[f"model.{k}"] = v
        confs.append(conf)
    port = Runner(confs[0], device="cpu")
    want = jax_resolved(jrunner.Runner(confs[1]), monkeypatch)
    assert port.tiers == want
    assert tr.resolved_tiers(port.rcfg, port.ucfg) == want


B = 32


def _batch(seed=3):
    """B rays from one camera through the unit cube's middle."""
    rng = np.random.default_rng(seed)
    origin = np.array([0.4, -2.1, 0.6], np.float32)
    target = rng.uniform(-0.6, 0.6, (B, 3)).astype(np.float32)
    rays_d = target - origin
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    return {"rays_o": np.broadcast_to(origin, rays_d.shape).copy(),
            "rays_d": rays_d,
            "edge": rng.uniform(0, 1, (B, 1)).astype(np.float32),
            "depth_scale": rng.uniform(0.8, 1.0, (B, 1)).astype(np.float32),
            "rays_ndc_uv": np.zeros((B, 2), np.float32)}


def tpu_default_udf_value(params, pts, cfg):
    """emap_tpu.fields.udf.udf_value as the TPU computes it at
    Precision.DEFAULT: each dot's operands rounded to bf16, fp32 products and
    sums (XLA on the CPU computes DEFAULT in fp32). Other tiers pass
    through."""
    if cfg.precision != "default":
        return judf.udf_value(params, pts, cfg)
    inputs = positional_encoding(pts * cfg.scale, cfg.multires)
    x = inputs
    n_linear = len(cfg.dims) - 1
    for l in range(n_linear):
        if l in cfg.skip_in:
            x = jnp.concatenate([x, inputs], axis=-1) / jnp.sqrt(2.0).astype(
                x.dtype)
        w = judf._effective_weight(params[f"lin{l}"])
        x = jnp.dot(x.astype(jnp.bfloat16), w.T.astype(jnp.bfloat16),
                    preferred_element_type=jnp.float32) + params[
                        f"lin{l}"]["b"]
        if l < n_linear - 1:
            x = judf._softplus100(x)
    return judf._udf_head(x[..., :1], cfg.udf_type)[..., 0] / cfg.scale


def _sorted_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _sorted_items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _field_errors(got, want):
    """(max error over the field's largest entry, worst multi-element leaf's
    max relative error) between two udf gradient trees."""
    pairs = [(np.asarray(g.detach()), np.asarray(w)) for (_, g), (_, w) in
             zip(_sorted_items(got), _sorted_items(want))]
    scale = max(np.abs(w).max() for _, w in pairs)
    whole = max(np.abs(g - w).max() for g, w in pairs) / scale
    return whole, max(max_rel(g, w) for g, w in pairs if g.size > 1)


def test_train_step_at_the_production_tiers_matches_jax(monkeypatch):
    """One training step at the JAX package's production tiers (field and
    adjoint "default", up-sampler "default", model "high") against its
    build_train_step with the fused kernels forced on (interpret mode) and
    the up-sampler given the TPU's DEFAULT. The field gradients are read
    from Adam's first moment. Measured: loss 4.7e-7 relative; field
    gradients 2.8e-4 of the field's largest, 9.0e-4 in the worst leaf;
    against the JAX step at "highest" everywhere 2.5e-2."""
    render_kw = dict(n_samples=8, n_importance=5, up_sample_steps=5,
                     perturb=0.0)
    train_kw = dict(batch_size=B, end_iter=100, learning_rate=0.0,
                    warm_up_end=1.0, anneal_end=2.0, fix_geo_end=0.0,
                    near=0.05, far=4.5)
    init = dict(variance_init=0.5, beta_init=0.5, gamma_init=0.3,
                zeta_init=0.3, requires_grad_beta=False,
                requires_grad_zeta=False)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jpool = jds.RayPool(edges=jnp.zeros((1, 4)), cdf=jnp.zeros((1, 4)),
                        intrinsics_inv=jnp.eye(3)[None], rot=jnp.eye(3)[None],
                        origin=jnp.zeros((1, 3)), H=2, W=2, n_images=1)
    toy = dict(TOY, multires=4)
    tucfg = tudf.UDFConfig(**toy)
    trcfg = tr.RenderConfig(**render_kw, field_precision="default")
    assert tr.resolved_tiers(trcfg, tucfg) == {
        "field": "default", "adjoint": "default", "sampler": "default",
        "extraction": "high", "route": "kernels"}

    def jax_step(prec, sampler, field, pallas):
        jucfg = judf.UDFConfig(precision=prec, pallas_train=pallas,
                               tile_fwd=128, tile_bwd=128, **toy)
        jrcfg = jr.RenderConfig(sampler_precision=sampler,
                                field_precision=field, **render_kw)
        jst = jstate.init_train_state(0, jucfg, **init)
        jfn = jstep.build_train_step(
            jstep.TrainConfig(**train_kw), jrcfg, jucfg, 1, donate=False,
            sample_fn=lambda s, p, k: (jbatch, jnp.int32(0)))
        with monkeypatch.context() as m:
            m.setattr(jr, "udf_value", tpu_default_udf_value)
            jst, jm = jfn(jst, jpool)
        return jst, jm

    jst, jm = jax_step("high", "default", "default", "on")
    jst_hi, _ = jax_step("highest", "highest", "", "auto")
    flags = {k: bool(getattr(jst, k)) for k in convert.FLAG_KEYS}
    tst = convert.make_state(convert.params_from_numpy(
        jax.tree.map(np.asarray, jstate.init_train_state(
            0, judf.UDFConfig(**toy), **init).params), tucfg, device="cpu"),
        0, "cpu", flags=flags)
    tfn = tstep.build_train_step(tstep.TrainConfig(**train_kw), trcfg, tucfg,
                                 1, sample_fn=lambda s, p: (tbatch, 0))
    tm = tfn(tst, None)
    loss, want = float(tm["loss"]), float(jm["loss"])
    assert abs(loss - want) < 1e-5 * abs(want)
    whole, leaf = _field_errors(tst.opt.mu["udf"], jax.tree.map(
        np.asarray, jst.opt.mu["udf"]))
    assert whole < 2e-3 and leaf < 5e-3
    whole_hi, _ = _field_errors(tst.opt.mu["udf"], jax.tree.map(
        np.asarray, jst_hi.opt.mu["udf"]))
    assert whole_hi > 5 * whole
