"""The port's sampling and renderer (emap_tpu_torch/render) against the JAX
package on the CPU: the same rays, z values and field give the same
samples, outputs and parameter gradients, with the "classical" and the
"mix" up-sampler (and a training step with "mix").

The JAX side runs at precision "highest" through XLA autodiff; the port's
render_core takes its fused-kernel path (the kernels' plain versions on the
CPU) and, with pallas_train = "off", plain autograd."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu.data import dataset as jds
from emap_tpu.fields import udf as judf
from emap_tpu.render import renderer as jr
from emap_tpu.render import sampling as js
from emap_tpu.train import state as jstate
from emap_tpu.train import step as jstep
from emap_tpu_torch.ckpt import convert
from emap_tpu_torch.ckpt.convert import params_from_numpy
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.render import renderer as tr
from emap_tpu_torch.render import sampling as ts
from emap_tpu_torch.train import step as tstep

TOY = dict(d_hidden=64, n_layers=8, multires=4)
B = 24


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def sorted_leaves(tree) -> list:
    """Leaves in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    return [tree]


def scene(seed=0):
    """Params (JAX, port), configs and B rays from a camera at radius 2.2
    looking at the unit cube."""
    jcfg = judf.UDFConfig(precision="highest", **TOY)
    tcfg = tudf.UDFConfig(**TOY)
    rng = np.random.default_rng(seed)
    udf = jax.tree.map(np.asarray, judf.init_udf_params(jax.random.key(seed),
                                                        jcfg))
    udf = jax.tree.map(lambda a: (a + 0.02 * rng.normal(size=a.shape))
                       .astype(np.float32), udf)
    tree = {"udf": udf,
            "variance": {"variance": np.array([0.3], np.float32),
                         "second_variance": np.array([0.3], np.float32)},
            "beta": {"beta": np.array([0.5], np.float32),
                     "gamma": np.array([0.3], np.float32),
                     "zeta": np.array([0.3], np.float32)}}
    origin = np.array([0.3, -2.0, 0.8], np.float32)
    target = rng.uniform(-0.6, 0.6, (B, 3)).astype(np.float32)
    rays_d = target - origin
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays_o = np.broadcast_to(origin, rays_d.shape).copy()
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            params_from_numpy(tree, tcfg, device="cpu"), rays_o, rays_d)


def rcfgs(**kw):
    base = dict(n_samples=16, n_importance=10, up_sample_steps=5,
                perturb=0.0)
    base.update(kw)
    return (jr.RenderConfig(sampler_precision="highest", **base),
            tr.RenderConfig(sampler_precision="highest", **base))


def test_render_config_matches():
    jf = {f.name: f.default for f in dataclasses.fields(jr.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tr.RenderConfig)}
    assert tf == jf
    from emap_tpu import config as jconfig
    from emap_tpu_torch import config as tconfig

    text = "n_samples = 32\nupsampling_type = classical\nperturb = 0.5"
    assert dataclasses.asdict(tr.RenderConfig.from_conf(
        tconfig.parse_string(text))) == dataclasses.asdict(
        jr.RenderConfig.from_conf(jconfig.parse_string(text)))
    assert tr.RenderConfig().total_samples == 114


@pytest.mark.parametrize("option", [{"n_outside": 32},
                                    {"upsampling_type": "mix"}])
def test_unported_render_options_raise(option):
    """The NeRF++ background is not ported: a conf that selects it fails at
    once instead of rendering something else. The "mix" up-sampler is
    ported: its config counts the samples it delivers as the JAX package's
    does, the reference's under-delivery included (the renders and the step
    are held to the JAX package below)."""
    if "n_outside" in option:
        with pytest.raises(NotImplementedError):
            tr.RenderConfig(**option)
        return
    for n_importance, steps in ((50, 5), (10, 5), (12, 3), (0, 5)):
        kw = dict(option, n_importance=n_importance, up_sample_steps=steps)
        got, want = tr.RenderConfig(**kw), jr.RenderConfig(**kw)
        assert got.n_importance_delivered == want.n_importance_delivered
        assert got.total_samples == want.total_samples
    assert tr.RenderConfig(**option).total_samples == 112  # ABC widths
    with pytest.raises(ValueError, match="upsampling_type"):
        tr.RenderConfig(upsampling_type="other")


def test_query_field_refuses_nets_the_kernels_do_not_take():
    """With the fused query on, a net the kernels do not take (a
    two-channel head; a hidden width that is not a multiple of 4) raises, on
    the CPU as on the card; pallas_train = "off" takes plain autograd for
    it."""
    pts = torch.rand(10, 3, generator=torch.Generator().manual_seed(1))
    for cfg in (tudf.UDFConfig(d_out=2, **TOY),
                tudf.UDFConfig(**dict(TOY, d_hidden=30))):
        params = {"udf": tudf.init_udf_params(
            torch.Generator().manual_seed(0), cfg, device="cpu")}
        with pytest.raises(ValueError, match="pallas_train"):
            tr.query_field(params, pts, cfg)
        off = dataclasses.replace(cfg, pallas_train="off")
        u, g = tr.query_field(params, pts, off)
        uw, gw = tudf.udf_value_and_gradient(params["udf"], pts, off)
        assert u.shape == (10,) and g.shape == (10, 3)
        assert torch.equal(u, uw) and torch.equal(g, gw)


def test_stratified_z_vals():
    got = ts.stratified_z_vals(None, 4, 0.05, 4.5, 64, 0.0, device="cpu")
    want = js.stratified_z_vals(jax.random.key(0), 4, 0.05, 4.5, 64, 0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    z = ts.stratified_z_vals(gen, 64, 0.05, 4.5, 64, 1.0, device="cpu")
    shift = (z - got[:1]).numpy()
    # one jitter per ray, within +-1/n_samples of the range's unit
    assert np.allclose(shift, shift[:, :1], atol=1e-5)
    assert np.abs(shift).max() <= 1.0 / 64 + 1e-6


def test_sample_pdf_with_given_uniforms():
    rng = np.random.default_rng(1)
    bins = np.sort(rng.uniform(0, 4, (B, 17)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (B, 16)).astype(np.float32)
    weights[:, 3:7] = 0.0
    for u in (None, np.sort(rng.uniform(0, 1, 9)).astype(np.float32)):
        got = ts.sample_pdf(torch.as_tensor(bins), torch.as_tensor(weights),
                            9, det=True, u=None if u is None else
                            torch.as_tensor(u))
        want = js.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 9,
                             det=True, u=u)
        # float32 cumsums in another order, divided by small cdf steps
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-5)


@pytest.mark.parametrize("unbias", [True, False])
def test_up_samplers_match(unbias):
    _, _, _, _, rays_o, rays_d = scene()
    rng = np.random.default_rng(2)
    z = np.sort(rng.uniform(0.05, 4.5, (B, 16)), axis=-1).astype(np.float32)
    udf = rng.uniform(0, 0.3, (B, 16)).astype(np.float32)
    args = (rays_o, rays_d, z, udf)
    jf = js.up_sample_unbias if unbias else js.up_sample_no_occ_aware
    tf = ts.up_sample_unbias if unbias else ts.up_sample_no_occ_aware
    want = jf(*map(jnp.asarray, args), 0.07, 4, 64.0, 128.0, 40.0)
    got = tf(*map(torch.as_tensor, args), 0.07, 4, 64.0, 128.0, 40.0)
    # float32 cumprods and cumsums in another order over z in [0.05, 4.5]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)


def test_merge_matches_one_hot_merge():
    rng = np.random.default_rng(3)
    z = np.sort(rng.uniform(0, 4, (B, 16)), axis=-1).astype(np.float32)
    new = np.sort(rng.uniform(0, 4, (B, 5)), axis=-1).astype(np.float32)
    new[:, 0] = z[:, 2]  # a tie: the old sample goes first
    new = np.sort(new, axis=-1)  # the JAX merge takes sorted inputs
    u, nu = rng.uniform(size=(B, 16)), rng.uniform(size=(B, 5))
    got = ts.merge_z_vals(*(torch.as_tensor(a.astype(np.float32))
                            for a in (z, new, u, nu)))
    want = js._merge_z_vals(*(jnp.asarray(a.astype(np.float32))
                              for a in (z, new, u, nu)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["unbias", "no_occ_aware"])
def test_importance_sample_same_z_vals(mode):
    """The up-sampling rounds, then the merges: classical with the unbiased
    or the occlusion-blind up-sampler."""
    jcfg, tcfg, jp, tp, rays_o, rays_d = scene()
    z0 = np.broadcast_to(np.linspace(0.05, 4.5, 16, dtype=np.float32),
                         (B, 16)).copy()

    def jrun(ro, rd, z):
        fn = lambda p: judf.udf_value(jp["udf"], p, jcfg)  # noqa: E731
        return js.importance_sample(fn, ro, rd, z, 0.3, 10, 5,
                                    use_unbias=mode == "unbias")

    want = jax.jit(jrun)(jnp.asarray(rays_o), jnp.asarray(rays_d),
                         jnp.asarray(z0))
    fn = lambda p: tudf.udf_value(tp["udf"], p, tcfg)  # noqa: E731
    got = ts.importance_sample(fn, torch.as_tensor(rays_o),
                               torch.as_tensor(rays_d), torch.as_tensor(z0),
                               0.3, 10, 5, use_unbias=mode == "unbias")
    assert got.shape == want.shape == (B, 26)
    # The fields agree to ~1e-6, but the samples are not smooth in them: the
    # steep sigmoids (inv_s up to 1024) and sample_pdf's `denom < 1e-5`
    # switch, which near-empty bins straddle, move single samples by up to
    # 5e-4 under 1e-6 relative field noise (one run of the whole suite saw
    # 1.06e-3 at z = 2.9 with these inputs). The JAX package holds the same
    # functions to the torch reference at this tolerance (test_render.py).
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)


RENDER_KEYS = ("udf", "edge", "weights", "s_val", "beta", "gamma", "depth",
               "gradient_error", "gradient_error_near_surface", "normals",
               "gradients", "gradients_flip", "gradient_mag", "alpha",
               "sparse_error")


ANNEAL, FLIP = 0.3, 0.9


@pytest.fixture(scope="module")
def render_core_case():
    """Fixed z values, per-key output weights, and the JAX package's
    render_core outputs and per-key parameter gradients (computed once)."""
    jcfg, _, jp, _, rays_o, rays_d = scene()
    jrc, _ = rcfgs()
    rng = np.random.default_rng(4)
    z = np.sort(rng.uniform(0.5, 3.8, (B, 26)), axis=-1).astype(np.float32)

    def out(p):
        return jr.render_core(p, jnp.asarray(rays_o), jnp.asarray(rays_d),
                              jnp.asarray(z), 0.07, jrc, jcfg, ANNEAL, FLIP)

    jout, vjp_fn = jax.vjp(out, jp)
    weights = {k: rng.normal(size=jout[k].shape).astype(np.float32)
               for k in RENDER_KEYS}
    # one compiled backward, fed one output's weights at a time
    vjp_fn = jax.jit(vjp_fn)
    zeros = jax.tree.map(jnp.zeros_like, jout)
    jgrad = {k: vjp_fn({**zeros, k: jnp.asarray(w)})[0]
             for k, w in weights.items()}
    return z, weights, jout, jgrad


@pytest.mark.parametrize("pallas_train", ["auto", "off"])
def test_render_core_outputs_and_param_grads(pallas_train, render_core_case):
    """Every output of render_core on fixed z values, and the parameter
    gradient of a random weighting of each, vs the JAX package."""
    z, weights, jout, jgrad = render_core_case
    _, tcfg, _, tp, rays_o, rays_d = scene()
    tcfg = dataclasses.replace(tcfg, pallas_train=pallas_train)
    _, trc = rcfgs()
    tleaves = [t.requires_grad_(True) for t in sorted_leaves(tp)]
    tout = tr.render_core(tp, torch.as_tensor(rays_o), torch.as_tensor(rays_d),
                          torch.as_tensor(z), 0.07, trc, tcfg, ANNEAL, FLIP)
    assert set(tout) == set(jout)
    for k in jout:
        assert tuple(tout[k].shape) == tuple(jout[k].shape), k
        np.testing.assert_allclose(
            tout[k].detach().numpy(), np.asarray(jout[k]), rtol=2e-5,
            atol=2e-5 * (float(np.abs(np.asarray(jout[k])).max()) + 1e-3),
            err_msg=k)

    for k, w in weights.items():
        loss = torch.sum(tout[k] * torch.as_tensor(w))
        grads = torch.autograd.grad(loss, tleaves, retain_graph=True,
                                    allow_unused=True)
        jleaves = jax.tree_util.tree_leaves(jgrad[k])
        for g, jg in zip(grads, jleaves):
            jg = np.asarray(jg)
            if g is None:
                assert np.abs(jg).max() == 0.0, k
                continue
            # Field weights: second-order float32 through the field, the
            # cumprods and steep sigmoids, measured ~1e-5. A scalar
            # (variance, beta, gamma) sums B x n terms of both signs, so
            # float32 cancellation shows: against a float64 run of the port
            # the port is off by 9e-4 and the JAX package by 1.8e-3 (weights
            # output, beta leaf). sparse_error is exp(-25000 udf): a udf
            # roundoff of 1e-7 moves it by 2.5e-3 relative.
            tol = 3e-4 if g.numel() > 1 else 5e-3
            if k == "sparse_error":
                tol = 1e-2
            assert max_rel(g, jg) < tol, k


def test_cumprod_of_positives_matches_torch_cumprod():
    """render_core's cumprod, whose backward makes no host sync: the value
    of torch.cumprod, and its gradient to float32 roundoff, on factors
    shaped like the renderer's (1, then 1 - alpha + 1e-7 with alpha in
    [0, 1], some saturated)."""
    rng = np.random.default_rng(6)
    alpha = rng.uniform(0, 1, (B, 40)).astype(np.float32)
    alpha[:, 5:9] = 1.0
    x = torch.cat([torch.ones(B, 1), 1.0 - torch.as_tensor(alpha) + 1e-7],
                  dim=-1)
    g = torch.as_tensor(rng.normal(size=(B, 41)).astype(np.float32))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    out = tr.cumprod_of_positives(a)
    want = torch.cumprod(b, dim=-1)
    assert torch.equal(out, want)
    (ga,) = torch.autograd.grad(out, a, g)
    (gb,) = torch.autograd.grad(want, b, g)
    # the same formula, sums from the right divided by x; torch may order
    # the terms otherwise
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), rtol=1e-5,
                               atol=1e-6 * float(gb.abs().max()))


def test_eikonal_at_zero_gradient():
    """safe_l2norm's gradient is 0 (torch's subgradient), not NaN, where the
    spatial gradient is exactly zero (tests/test_render.py)."""
    g0 = np.zeros((4, 3), np.float32)
    g0[1:] = 1.0

    def tloss(g):
        err = (tr.safe_l2norm(g, dim=-1) - 1.0) ** 2
        mag = tr.safe_l2norm(g, dim=-1, keepdim=True)
        return torch.sum(err) + torch.sum(g / (mag + 1e-5))

    def jloss(g):
        err = (jr._safe_l2norm(g, axis=-1) - 1.0) ** 2
        mag = jr._safe_l2norm(g, axis=-1, keepdims=True)
        return jnp.sum(err) + jnp.sum(g / (mag + 1e-5))

    g = torch.as_tensor(g0).requires_grad_(True)
    val = tloss(g)
    (grad,) = torch.autograd.grad(val, g)
    assert bool(torch.isfinite(grad).all())
    np.testing.assert_allclose(float(val.detach()), float(jloss(jnp.asarray(
        g0))), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jax.grad(jloss)(
        jnp.asarray(g0))), rtol=1e-6, atol=1e-6)
    (eik,) = torch.autograd.grad(torch.sum((tr.safe_l2norm(
        g, dim=-1) - 1.0) ** 2), g)
    assert float(eik[0].abs().max()) == 0.0


def test_render_core_at_zero_spatial_gradient():
    """A field whose spatial gradient is exactly zero at every sample (the
    last layer's weight-norm gain g = 0): finite outputs and gradients."""
    _, tcfg, _, tp, rays_o, rays_d = scene()
    tp["udf"]["lin8"]["g"] = torch.zeros_like(tp["udf"]["lin8"]["g"])
    leaves = [t.requires_grad_(True) for layer in tp["udf"].values()
              for t in layer.values()]
    _, trc = rcfgs()
    z = np.broadcast_to(np.linspace(0.5, 3.8, 26, dtype=np.float32),
                        (B, 26)).copy()
    out = tr.render_core(tp, torch.as_tensor(rays_o), torch.as_tensor(rays_d),
                         torch.as_tensor(z), 0.07, trc, tcfg, 1.0, 0.0)
    assert float(out["gradients"].abs().max()) == 0.0
    loss = out["edge"].sum() + 0.1 * out["gradient_error"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is None or bool(torch.isfinite(g).all()) for g in grads)


def test_render_matches():
    """render() end to end without jitter: the sampler, then render_core."""
    jcfg, tcfg, jp, tp, rays_o, rays_d = scene()
    jrc, trc = rcfgs(perturb=1.0)
    ds = np.ones((B, 1), np.float32)
    jout = jax.jit(lambda p, ro, rd, d: jr.render(
        p, ro, rd, 0.05, 4.5, d, jax.random.key(0), jrc, jcfg,
        cos_anneal_ratio=0.5, perturb_overwrite=0.0))(
        jp, jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.asarray(ds))
    tout = tr.render(tp, torch.as_tensor(rays_o), torch.as_tensor(rays_d),
                     0.05, 4.5, torch.as_tensor(ds), None, trc, tcfg,
                     cos_anneal_ratio=0.5, perturb_overwrite=0.0)
    assert set(tout) == set(jout)
    # the sampler's z shifts, as in test_importance_sample_same_z_vals
    np.testing.assert_allclose(tout["mid_z_vals"].numpy(),
                               np.asarray(jout["mid_z_vals"]), rtol=0,
                               atol=2e-4)
    for k in ("edge", "depth", "weight_sum", "gradient_error", "normals"):
        np.testing.assert_allclose(
            tout[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-3,
            atol=1e-4, err_msg=k)


def test_importance_sample_mix_same_z_vals():
    """The "mix" up-sampler: five occlusion-blind rounds with the learned
    gamma, one unbiased round, and their merges."""
    jcfg, tcfg, jp, tp, rays_o, rays_d = scene()
    z0 = np.broadcast_to(np.linspace(0.05, 4.5, 16, dtype=np.float32),
                         (B, 16)).copy()
    beta, gamma = 150.0, 25.0

    def jrun(ro, rd, z):
        fn = lambda p: judf.udf_value(jp["udf"], p, jcfg)  # noqa: E731
        return js.importance_sample_mix(fn, ro, rd, z, 0.3, 12, 5,
                                        jnp.float32(beta), jnp.float32(gamma))

    want = jax.jit(jrun)(jnp.asarray(rays_o), jnp.asarray(rays_d),
                         jnp.asarray(z0))
    fn = lambda p: tudf.udf_value(tp["udf"], p, tcfg)  # noqa: E731
    got = ts.importance_sample_mix(
        fn, torch.as_tensor(rays_o), torch.as_tensor(rays_d),
        torch.as_tensor(z0), 0.3, 12, 5, torch.tensor(beta),
        torch.tensor(gamma))
    assert got.shape == want.shape == (B, 16 + 12)
    # the tolerance of test_importance_sample_same_z_vals, for its reasons
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-3)


def test_render_mix_matches():
    """render() with upsampling_type = "mix", end to end without jitter:
    the learned beta/gamma, clipped, reach the up-sampler as in the JAX
    package."""
    jcfg, tcfg, jp, tp, rays_o, rays_d = scene()
    jrc, trc = rcfgs(perturb=1.0, n_importance=12, upsampling_type="mix")
    ds = np.ones((B, 1), np.float32)
    jout = jax.jit(lambda p, ro, rd, d: jr.render(
        p, ro, rd, 0.05, 4.5, d, jax.random.key(0), jrc, jcfg,
        cos_anneal_ratio=0.5, perturb_overwrite=0.0))(
        jp, jnp.asarray(rays_o), jnp.asarray(rays_d), jnp.asarray(ds))
    tout = tr.render(tp, torch.as_tensor(rays_o), torch.as_tensor(rays_d),
                     0.05, 4.5, torch.as_tensor(ds), None, trc, tcfg,
                     cos_anneal_ratio=0.5, perturb_overwrite=0.0)
    assert tout["mid_z_vals"].shape == (B, 16 + 12)
    # the samples to the tolerance of test_importance_sample_same_z_vals,
    # for its reasons (the mix rounds run at inv_s up to 1024 with the
    # learned gamma: 3 of 672 samples move by 4.3e-4 here); the outputs to
    # those of test_render_matches
    np.testing.assert_allclose(tout["mid_z_vals"].numpy(),
                               np.asarray(jout["mid_z_vals"]), rtol=1e-3,
                               atol=2e-3)
    for k in ("edge", "depth", "weight_sum", "gradient_error", "normals"):
        np.testing.assert_allclose(
            tout[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-3,
            atol=1e-4, err_msg=k)


def test_train_step_with_mix_matches():
    """One training step with the "mix" up-sampler against the JAX
    package's step on the same prescribed batch (perturb 0): the metrics,
    and the field's gradients read from Adam's first moment, to the
    tolerances of tests/test_torch_train.py's three-step comparison."""
    jucfg = judf.UDFConfig(precision="highest", **TOY)
    tucfg = tudf.UDFConfig(**TOY)
    render_kw = dict(n_samples=8, n_importance=12, up_sample_steps=5,
                     perturb=0.0, upsampling_type="mix")
    train_kw = dict(batch_size=B, end_iter=100, learning_rate=0.0,
                    warm_up_end=1.0, anneal_end=2.0, fix_geo_end=0.0,
                    near=0.05, far=4.5)
    jst = jstate.init_train_state(0, jucfg, variance_init=0.5, beta_init=0.5,
                                  gamma_init=0.3, zeta_init=0.3)
    flags = {k: bool(getattr(jst, k)) for k in convert.FLAG_KEYS}
    tst = convert.make_state(convert.params_from_numpy(
        jax.tree.map(np.asarray, jst.params), tucfg, device="cpu"), 0, "cpu",
        flags=flags)
    _, _, _, _, rays_o, rays_d = scene()
    rng = np.random.default_rng(5)
    batch = {"rays_o": rays_o, "rays_d": rays_d,
             "edge": rng.uniform(0, 1, (B, 1)).astype(np.float32),
             "depth_scale": np.ones((B, 1), np.float32),
             "rays_ndc_uv": np.zeros((B, 2), np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jpool = jds.RayPool(edges=jnp.zeros((1, 4)), cdf=jnp.zeros((1, 4)),
                        intrinsics_inv=jnp.eye(3)[None], rot=jnp.eye(3)[None],
                        origin=jnp.zeros((1, 3)), H=2, W=2, n_images=1)
    jfn = jstep.build_train_step(
        jstep.TrainConfig(**train_kw),
        jr.RenderConfig(sampler_precision="highest", **render_kw), jucfg, 1,
        donate=False, sample_fn=lambda s, p, k: (jbatch, jnp.int32(0)))
    tfn = tstep.build_train_step(
        tstep.TrainConfig(**train_kw),
        tr.RenderConfig(sampler_precision="highest", **render_kw), tucfg, 1,
        sample_fn=lambda s, p: (tbatch, 0))
    jst, jm = jfn(jst, jpool)
    tm = tfn(tst, None)
    for k in tstep.METRIC_KEYS:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=2e-5,
                                             abs=1e-6), k
    got = sorted_leaves(tst.opt.mu["udf"])
    want = [np.asarray(w) for w in sorted_leaves(
        jax.tree.map(np.asarray, jst.opt.mu["udf"]))]
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        g = g.numpy()
        # FIELD_RTOL of tests/test_torch_train.py: against the field's
        # largest gradient, and leaf by leaf for multi-element leaves
        assert np.abs(g - w).max() <= 3e-4 * scale
        if g.size > 1:
            assert max_rel(g, w) < 3e-4
