"""The port's schedules, masked Adam, train step, checkpoints and CLI
(emap_tpu_torch/train, ckpt, cli) against the JAX package on the CPU.

The step oracle is the JAX package's `build_train_step(..., donate=False,
sample_fn=...)`: the same batch goes through both steps with perturb = 0
(JAX `Runner.train` cannot run on the CPU; see ROADMAP.md queue 3)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu.ckpt import native as jnative
from emap_tpu.data import dataset as jds
from emap_tpu.fields import udf as judf
from emap_tpu.render import renderer as jr
from emap_tpu.train import optim as joptim
from emap_tpu.train import schedules as jsched
from emap_tpu.train import state as jstate
from emap_tpu.train import step as jstep
from emap_tpu_torch import cli, config
from emap_tpu_torch.ckpt import convert, native
from emap_tpu_torch.data import make_synthetic_scene
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.render import renderer as tr
from emap_tpu_torch.train import optim as toptim
from emap_tpu_torch.train import schedules as tsched
from emap_tpu_torch.train import step as tstep

TOY = dict(d_hidden=64, n_layers=8, multires=4)
B = 32


def max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-30))


def sorted_items(tree, prefix=""):
    """(path, leaf) pairs in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in sorted_items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


@pytest.mark.parametrize("step", [0, 1, 150, 199, 200, 999, 1000, 1999, 2000,
                                  9999, 10000, 24999, 25000, 37000, 49999])
def test_schedules_match(step):
    args = dict(warm_up_end=1000.0, end_iter=50000.0, alpha=0.05)
    assert tsched.lr_factor(step, **args) == pytest.approx(
        float(jsched.lr_factor(step, **args)), rel=1e-6, abs=1e-9)
    assert tsched.lr_factor_geo(step, 200.0, **args) == pytest.approx(
        float(jsched.lr_factor_geo(step, 200.0, **args)), rel=1e-6, abs=1e-9)
    for anneal_end in (0.0, 10000.0):
        assert tsched.cos_anneal_ratio(step, anneal_end) == pytest.approx(
            float(jsched.cos_anneal_ratio(step, anneal_end)), rel=1e-7)
    assert tsched.flip_saturation(step, 50000.0) == pytest.approx(
        float(jsched.flip_saturation(step, 50000.0)), rel=1e-7)


def test_masked_adam_matches():
    """Three updates with per-leaf lrs and masks; a mask of 0 freezes the
    param, both moments and the count."""
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32),
                    "d": rng.normal(size=(1,)).astype(np.float32)}}
    masks = [{"a": 1.0, "b": {"c": 0.0, "d": 1.0}},
             {"a": 1.0, "b": {"c": 1.0, "d": 0.0}},
             {"a": 0.0, "b": {"c": 1.0, "d": 1.0}}]
    lrs = {"a": 1e-3, "b": {"c": 5e-4, "d": 2e-2}}
    jp = jax.tree.map(jnp.asarray, params)
    js = joptim.adam_init(jp)
    tp = toptim.tree_map(torch.as_tensor, params)
    ts = toptim.adam_init(tp)
    for mask in masks:
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32), params)
        jp, js = joptim.adam_update(
            jp, jax.tree.map(jnp.asarray, grads), js,
            jax.tree.map(jnp.float32, lrs), jax.tree.map(jnp.float32, mask))
        toptim.adam_update(
            tp, toptim.tree_map(torch.as_tensor, grads), ts, lrs,
            toptim.tree_map(lambda m: torch.tensor(m), mask))
    for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu),
                      (ts.count, js.count)):
        for (path, g), (_, w) in zip(sorted_items(got), sorted_items(
                jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6, atol=1e-8,
                                       err_msg=path)
    assert float(ts.count["b"]["c"]) == 2.0 and float(ts.count["a"]) == 2.0


def _batch(seed=3):
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


@pytest.fixture(scope="module")
def matched_steps():
    """Three steps of both packages from one state on one batch."""
    jucfg = judf.UDFConfig(precision="highest", **TOY)
    tucfg = tudf.UDFConfig(**TOY)
    render_kw = dict(n_samples=8, n_importance=5, up_sample_steps=5,
                     perturb=0.0)
    jrcfg = jr.RenderConfig(sampler_precision="highest", **render_kw)
    trcfg = tr.RenderConfig(sampler_precision="highest", **render_kw)
    # learning_rate 0 keeps the scalars (variance, beta, gamma) in place:
    # their float32 gradients are mostly cancellation noise at this size
    # (SCALAR_GRAD_ATOL), and Adam would turn that noise into lr-sized
    # moves; the field weights train at learning_rate_geo
    train_kw = dict(batch_size=B, end_iter=100, learning_rate=0.0,
                    warm_up_end=1.0, anneal_end=2.0, fix_geo_end=0.0,
                    near=0.05, far=4.5)
    # s_val = e^-5 < 2 / beta = 2 e^-5 and < 0.01: the beta gate fires on
    # step 0, so beta (frozen by requires_grad_beta=False) trains from step 1
    init = dict(variance_init=0.5, beta_init=0.5, gamma_init=0.3,
                zeta_init=0.3, requires_grad_beta=False,
                requires_grad_zeta=False)
    jst = jstate.init_train_state(0, jucfg, **init)
    flags = {k: bool(getattr(jst, k)) for k in convert.FLAG_KEYS}
    tst = convert.make_state(
        convert.params_from_numpy(jax.tree.map(np.asarray, jst.params),
                                  tucfg, device="cpu"),
        0, "cpu", flags=flags)

    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jpool = jds.RayPool(edges=jnp.zeros((1, 4)), cdf=jnp.zeros((1, 4)),
                        intrinsics_inv=jnp.eye(3)[None], rot=jnp.eye(3)[None],
                        origin=jnp.zeros((1, 3)), H=2, W=2, n_images=1)
    jfn = jstep.build_train_step(
        jstep.TrainConfig(**train_kw), jrcfg, jucfg, 1, donate=False,
        sample_fn=lambda s, p, k: (jbatch, jnp.int32(0)))
    tfn = tstep.build_train_step(
        tstep.TrainConfig(**train_kw), trcfg, tucfg, 1,
        sample_fn=lambda s, p: (tbatch, 0))
    jm, tm, j_mu1, t_mu1 = [], [], None, None
    for i in range(3):
        jst, m = jfn(jst, jpool)
        jm.append(jax.tree.map(np.asarray, m))
        tm.append(tfn(tst, None))
        if i == 0:
            j_mu1 = jax.tree.map(np.asarray, jst.opt.mu)
            t_mu1 = toptim.tree_map(lambda t: t.clone(), tst.opt.mu)
    return jst, tst, jm, tm, j_mu1, t_mu1, tucfg


def test_step_metrics_match(matched_steps):
    _, _, jm, tm, _, _, _ = matched_steps
    for i, (j, t) in enumerate(zip(jm, tm)):
        for k in tstep.METRIC_KEYS:
            # float32 through render and the second-order field query;
            # udf values of ~0.5 carry ~1e-7 of roundoff
            assert float(t[k]) == pytest.approx(float(j[k]), rel=2e-5,
                                                abs=1e-6), (i, k)
        assert bool(t["beta_trainable"]) == bool(j["beta_trainable"])
    assert [bool(t["beta_trainable"]) for t in tm] == [True] * 3


# Some gradients are sums of B x n terms of both signs through saturated
# float32 sigmoids, and float32 keeps few of their digits at this toy size.
# The scalars (variance, beta, gamma): for variance, whose float64 value is
# 4.0e-8 here, the port's autograd path gives 4.0e-8, its fused path 2.3e-8
# and the JAX package 6.3e-8; they are held to that noise floor. The field's
# last bias, lin8/b: 9.2e-6 vs 1.0e-5, against field gradients up to 2.5e-2;
# the field is held leaf by leaf where a leaf has more than one element and
# as one vector (max error over max value) throughout. (At ABC width on the
# card the kernel and autograd paths agree on every leaf, scalars included,
# to 1e-5 relative: chip_smoke.py.)
SCALAR_GRAD_ATOL = 1e-7
FIELD_RTOL = 3e-4


def _field_close(got, want, rtol):
    """got, want: the udf subtrees; each multi-element leaf to `rtol` of its
    own max, and every leaf to `rtol` of the whole field's max."""
    pairs = [(p, np.asarray(g.detach() if hasattr(g, "detach") else g),
              np.asarray(w)) for (p, g), (_, w) in zip(sorted_items(got),
                                                     sorted_items(want))]
    scale = max(np.abs(w).max() for _, _, w in pairs)
    for path, g, w in pairs:
        assert np.abs(g - w).max() <= rtol * scale, path
        if g.size > 1:
            assert max_rel(g, w) < rtol, path


def test_step_grads_match(matched_steps):
    """The first step's gradients, read from Adam's first moment
    (mu = (1 - b1) g after one update)."""
    _, _, _, _, j_mu1, t_mu1, _ = matched_steps
    _field_close(t_mu1["udf"], j_mu1["udf"], FIELD_RTOL)
    for group in ("variance", "beta"):
        for (path, g), (_, w) in zip(sorted_items(t_mu1[group]),
                                     sorted_items(j_mu1[group])):
            assert abs(float(g) - float(w[0])) < 0.1 * SCALAR_GRAD_ATOL, path
    assert float(t_mu1["beta"]["beta"].abs().max()) == 0.0  # frozen


def test_state_after_three_steps_matches(matched_steps):
    """Field weights and both moments after three steps; the scalars'
    values, step counts and frozen leaves."""
    jst, tst, _, _, _, _, _ = matched_steps
    jp0 = jax.tree.map(np.asarray, jstate.init_train_state(
        0, judf.UDFConfig(precision="highest", **TOY)).params["udf"])
    p0 = dict(sorted_items(jp0))
    jp3 = dict(sorted_items(jax.tree.map(np.asarray, jst.params["udf"])))
    # Adam moves each weight by about lr per step whatever the gradient's
    # size, so compare the moves: 1% of the largest move in the leaf, and 5%
    # of the largest in the field for lin8/b, whose gradient is near the
    # noise floor above (measured 4%)
    field_move = max(np.abs(jp3[p] - p0[p]).max() for p in p0)
    for path, g in sorted_items(tst.params["udf"]):
        w, g = jp3[path], g.detach().numpy()
        atol = (1e-2 * np.abs(w - p0[path]).max() if w.size > 1
                else 5e-2 * field_move)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol + 1e-7,
                                   err_msg=path)
    _field_close(tst.opt.mu["udf"], jax.tree.map(np.asarray,
                                                 jst.opt.mu["udf"]),
                 FIELD_RTOL)
    _field_close(tst.opt.nu["udf"], jax.tree.map(np.asarray,
                                                 jst.opt.nu["udf"]),
                 2 * FIELD_RTOL)  # squares of the gradients
    for (path, g), (_, w) in zip(sorted_items(tst.opt.count), sorted_items(
            jax.tree.map(np.asarray, jst.opt.count))):
        assert float(g) == float(w), path
    assert float(tst.opt.count["beta"]["beta"]) == 2.0  # frozen on step 0
    assert float(tst.opt.count["beta"]["zeta"]) == 0.0
    for group in ("variance", "beta"):
        for (path, g), (_, w) in zip(
                sorted_items(tst.params[group]),
                sorted_items(jax.tree.map(np.asarray, jst.params[group]))):
            assert float(g.detach()[0]) == float(w[0]), path
    for k in convert.FLAG_KEYS:
        assert bool(getattr(tst, k)) == bool(getattr(jst, k)), k
    assert tst.step == int(jst.step) == 3


def test_checkpoints_cross_between_packages(tmp_path, matched_steps):
    """A port checkpoint loads with the JAX package's load_pytree, and a
    JAX checkpoint loads into the port, leaf for leaf."""
    jst, tst, _, _, _, _, tucfg = matched_steps
    path = str(tmp_path / "port.npz")
    native.save_pytree(path, convert.checkpoint_payload(tst, 0.25))
    loaded = jnative.load_pytree(path)
    assert int(loaded["iter_step"]) == 3
    assert float(loaded["best_loss"]) == 0.25
    for (p, g), (_, w) in zip(
            sorted_items(loaded["params"]),
            sorted_items(convert.params_to_numpy(tst.params))):
        np.testing.assert_array_equal(g, w, err_msg=p)
    assert set(loaded["flags"]) == set(convert.FLAG_KEYS)

    jpath = str(tmp_path / "jax.npz")
    jnative.save_pytree(jpath, {
        "params": jst.params,
        "opt": {"mu": jst.opt.mu, "nu": jst.opt.nu, "count": jst.opt.count},
        "iter_step": np.asarray(jst.step),
        "flags": {k: np.asarray(getattr(jst, k)) for k in convert.FLAG_KEYS},
        "best_loss": np.asarray(0.5, np.float32)})
    st = convert.state_from_payload(native.load_pytree(jpath), tucfg, 0, "cpu")
    assert st.step == 3
    for (p, g), (_, w) in zip(sorted_items(st.params), sorted_items(
            jax.tree.map(np.asarray, jst.params))):
        np.testing.assert_array_equal(g.detach().numpy(), w, err_msg=p)
    for (p, g), (_, w) in zip(sorted_items(st.opt.nu), sorted_items(
            jax.tree.map(np.asarray, jst.opt.nu))):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=p)


def _tiny_conf(tmp_path, end_iter=2):
    data_dir = str(tmp_path / "data")
    make_synthetic_scene(data_dir, scan="cube000", n_views=3, H=32, W=32)
    conf = config.parse_file(os.path.join(os.path.dirname(os.path.dirname(
        __file__)), "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = str(tmp_path / "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    for k, v in {"end_iter": end_iter, "batch_size": 16, "report_freq": 1,
                 "save_freq": 1, "val_freq": 100}.items():
        conf[f"train.{k}"] = v
    for k, v in TOY.items():
        conf[f"model.udf_network.{k}"] = v
    conf["model.udf_renderer.n_samples"] = 8
    conf["model.udf_renderer.n_importance"] = 5
    path = str(tmp_path / "tiny.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def test_cli_trains_and_writes_a_jax_readable_checkpoint(tmp_path):
    """`emap_tpu_torch.cli` trains 2 steps on the CPU and leaves an npz that
    the JAX package reads and evaluates like the port."""
    path = _tiny_conf(tmp_path)
    runner = cli.main(["--conf", path, "--mode", "train", "--device", "cpu"])
    assert runner.state.step == 2
    assert [h["step"] for h in runner.history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in runner.history)
    ckpt = os.path.join(runner.base_exp_dir, "checkpoints", "ckpt_best.npz")
    payload = jnative.load_pytree(ckpt)
    assert int(payload["iter_step"]) == 2
    assert set(payload["params"]) == {"udf", "variance", "beta"}
    jcfg = judf.UDFConfig(precision="highest", **TOY)
    pts = np.random.default_rng(0).uniform(-1, 1, (64, 3)).astype(np.float32)
    want = np.asarray(judf.udf_value(jax.tree.map(
        jnp.asarray, payload["params"]["udf"]), jnp.asarray(pts), jcfg))
    got = tudf.udf_value(runner.state.params["udf"], torch.as_tensor(pts),
                         runner.ucfg).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert os.path.exists(os.path.join(runner.base_exp_dir, "recording",
                                       "config.conf"))

    # a fresh runner resumes from it
    again = cli.main(["--conf", path, "--device", "cpu", "--is_continue"])
    assert again.state.step == 2 and again.history == []


def test_later_slices_raise(tmp_path):
    """Nothing here is left to later slices: the `mix` up-sampler is ported
    (tests/test_torch_render.py), and so is the `.pth` import
    (tests/test_torch_pth.py): a `.pth` that is not there and has no .npz
    beside it is a missing file. Thick scene lines are ported too
    (tests/test_torch_data.py)."""
    path = _tiny_conf(tmp_path)
    runner = cli.main(["--conf", path, "--mode", "train", "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        runner.load_checkpoint("reference.pth")
    assert tr.RenderConfig(upsampling_type="mix").total_samples == 64 + 48


def test_validation_views_follow_the_reference_stream(tmp_path):
    """Validation views are numpy's MT19937 stream after seed 42, as the JAX
    package draws them (np.random.seed(42) in its CLI, then
    np.random.randint), and numpy's global state is left alone."""
    path = _tiny_conf(tmp_path)
    runner = cli.main(["--conf", path, "--mode", "train", "--device", "cpu"])
    n = runner.scene.n_images
    before = np.random.get_state()
    np.random.seed(42)
    want = [int(np.random.randint(n)) for _ in range(50)]
    np.random.set_state(before)
    paths = runner.validate(resolution_level=8)
    assert os.path.basename(paths["edge_maps"]) == f"00000002_{want[0]}.png"
    got = [want[0]] + [int(runner.val_rng.randint(n)) for _ in range(49)]
    assert got == want
    assert len(set(want)) == n == 3
    np.testing.assert_array_equal(np.random.get_state()[1], before[1])


def test_stopped_run_resumes_exactly(tmp_path, monkeypatch):
    """`--stop_at` then `--is_continue` gives the state, best checkpoint and
    losses of the run that did not stop (the loss window shortened to 2
    steps so that the stop grid is small); a stop off the grid raises."""
    from emap_tpu_torch.train import runner as trunner

    monkeypatch.setattr(trunner, "LOSS_WINDOW", 2)
    whole = _tiny_conf(tmp_path / "whole", end_iter=6)
    split = _tiny_conf(tmp_path / "split", end_iter=6)
    ref = cli.main(["--conf", whole, "--device", "cpu"])
    first = cli.main(["--conf", split, "--device", "cpu", "--stop_at", "4"])
    assert first.state.step == 4
    stop = os.path.join(first._ckpt_dir(), "ckpt_stop.npz")
    assert os.path.exists(stop)
    second = cli.main(["--conf", split, "--device", "cpu", "--is_continue"])
    assert second.state.step == 6 and not os.path.exists(stop)
    assert [h["loss"] for h in first.history + second.history] == [
        h["loss"] for h in ref.history]
    got = convert.checkpoint_payload(second.state, second.best_loss)
    want = convert.checkpoint_payload(ref.state, ref.best_loss)
    for (k, g), w in zip(_flat(got).items(), _flat(want).values()):
        np.testing.assert_array_equal(g, w, err_msg=k)
    a = native.load_pytree(os.path.join(ref._ckpt_dir(), "ckpt_best.npz"))
    b = native.load_pytree(os.path.join(second._ckpt_dir(), "ckpt_best.npz"))
    for (k, g), w in zip(_flat(b).items(), _flat(a).values()):
        np.testing.assert_array_equal(g, w, err_msg=k)
    with pytest.raises(ValueError, match="stop_at"):
        cli.main(["--conf", split, "--device", "cpu", "--stop_at", "3"])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): np.asarray(tree)}
