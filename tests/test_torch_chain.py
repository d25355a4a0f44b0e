"""The port's chained dispatch (train.steps_per_dispatch) and profiler window
(train.profile_steps) on the CPU: the chain rule of the JAX runner, the
chained step against single steps and against the JAX package's steps, and
a runner whose events land on the steps of a chain-1 run.

On the CPU the chained step runs its steps eagerly, so it equals the single
steps bit for bit; on the card it replays a CUDA graph of the step, which
tests/test_torch_cuda.py holds to the same bits."""

import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emap_tpu.data import dataset as jds
from emap_tpu.fields import udf as judf
from emap_tpu.render import renderer as jr
from emap_tpu.train import state as jstate
from emap_tpu.train import step as jstep
from emap_tpu_torch import cli, config
from emap_tpu_torch.ckpt import convert, native
from emap_tpu_torch.data import make_synthetic_scene
from emap_tpu_torch.fields import udf as tudf
from emap_tpu_torch.render import renderer as tr
from emap_tpu_torch.train import runner as trunner
from emap_tpu_torch.train import step as tstep

TOY = dict(d_hidden=64, n_layers=8, multires=4)
B = 32


# (steps_per_dispatch, report_freq, save_freq, val_freq, profile_steps)
# -> chain, worked from emap_tpu/train/runner.py:297-313
CHAIN_CASES = [
    ((0, 1000, 1000, 1000, 0), 500),  # confs/ABC.conf: the default
    ((0, 5, 10, 20, 0), 5),  # chip_smoke.py's cadences
    ((0, 100, 300, 700, 0), 100),  # gcd(500, 100, 300, 700)
    ((0, 1, 1, 100, 0), 1),  # tests' tiny confs: per-step dispatch
    ((250, 1000, 1000, 1000, 0), 250),  # divides the cadences: kept
    ((300, 1000, 1000, 1000, 0), 100),  # rounded down to gcd(300, 500)
    ((7, 1000, 1000, 1000, 0), 1),  # coprime: rounded down to 1
    ((1000, 1000, 1000, 1000, 0), 500),  # above the clamp: gcd(1000, 500)
    ((1, 1000, 1000, 1000, 0), 1),  # the eager path, asked for
    ((0, 1000, 1000, 1000, 3), 1),  # a profiler window forces 1
    ((250, 1000, 1000, 1000, 3), 1),
]


@pytest.mark.parametrize("args,want", CHAIN_CASES)
def test_dispatch_chain_follows_the_jax_rule(args, want, caplog):
    with caplog.at_level(logging.WARNING):
        assert trunner.dispatch_chain(*args) == want
    rounded = args[0] > 0 and 500 % args[0] != 0
    assert ("rounding down" in caplog.text) == rounded


def _conf(tmp_path, end_iter, **train):
    """confs/ABC.conf at toy width on a 3-view 32x32 cube, with `train`
    keys overriding the cadences."""
    data_dir = str(tmp_path / "data")
    if not os.path.exists(data_dir):
        make_synthetic_scene(data_dir, scan="cube000", n_views=3, H=32, W=32)
    conf = config.parse_file(os.path.join(os.path.dirname(os.path.dirname(
        __file__)), "confs", "ABC.conf"))
    conf["general.base_exp_dir"] = str(tmp_path / "exp")
    conf["general.recording"] = []
    conf["dataset.data_dir"] = data_dir
    conf["dataset.scan"] = "cube000"
    for k, v in {"end_iter": end_iter, "batch_size": 16,
                 "validate_resolution_level": 4, **train}.items():
        conf[f"train.{k}"] = v
    for k, v in TOY.items():
        conf[f"model.udf_network.{k}"] = v
    conf["model.udf_renderer.n_samples"] = 8
    conf["model.udf_renderer.n_importance"] = 5
    path = str(tmp_path / "tiny.conf")
    with open(path, "w") as f:
        f.write(conf.to_hocon())
    return path


def _state_arrays(st) -> dict:
    """Every tensor of a TrainState as numpy, with its step and generator."""
    out = _flat(convert.checkpoint_payload(st, 0.0))
    out["generator"] = st.generator.get_state().numpy()
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix.rstrip("/"): np.asarray(tree)}


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_chained_step_equals_single_steps(tmp_path):
    """K = 4 chained steps and 4 single steps from one state: the same
    state (parameters, Adam moments and counts, gates, step, generator) and
    the same metric rows, bit for bit."""
    path = _conf(tmp_path, 8)
    a = trunner.Runner(config.parse_file(path), "train", device="cpu")
    b = trunner.Runner(config.parse_file(path), "train", device="cpu")
    args = (a.tcfg, a.rcfg, a.ucfg, a.scene.n_images)
    single = tstep.build_train_step(*args)
    want = torch.stack([tstep.pack_metrics(single(a.state, a.pool))
                        for _ in range(4)])
    chained = tstep.build_chained_train_step(*args, 4)
    got = chained(b.state, b.pool)
    assert got.shape == (4, len(tstep.METRIC_KEYS))
    assert torch.equal(got, want)
    assert b.state.step == a.state.step == 4
    _assert_same(_state_arrays(b.state), _state_arrays(a.state))


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


def _sorted_items(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _sorted_items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def _field_close(got, want, rtol):
    """Each multi-element leaf to `rtol` of its own max, every leaf to
    `rtol` of the field's max (tests/test_torch_train.py)."""
    pairs = [(p, np.asarray(g.detach()), np.asarray(w))
             for (p, g), (_, w) in zip(_sorted_items(got),
                                       _sorted_items(want))]
    scale = max(np.abs(w).max() for _, _, w in pairs)
    for path, g, w in pairs:
        assert np.abs(g - w).max() <= rtol * scale, path
        if g.size > 1:
            d = np.abs(g - w).max() / (np.abs(w).max() + 1e-30)
            assert d < rtol, path


def test_chained_steps_match_the_jax_steps():
    """A chain of 3 port steps on a prescribed batch (perturb 0) against 3
    of the JAX package's `build_train_step(..., donate=False,
    sample_fn=...)` steps, to the tolerances of tests/test_torch_train.py::
    test_step_metrics_match and test_state_after_three_steps_matches (and
    for their reasons). Those bounds hold for three steps: after a fourth,
    2 of lin0/v's 1,728 weights differ by 1.8% of the field's largest move
    (Adam moves a weight by ~lr whatever its gradient, so float32 noise in a
    near-zero gradient becomes a move). The chain itself equals single
    steps bit for bit (test_chained_step_equals_single_steps)."""
    jucfg = judf.UDFConfig(precision="highest", **TOY)
    tucfg = tudf.UDFConfig(**TOY)
    render_kw = dict(n_samples=8, n_importance=5, up_sample_steps=5,
                     perturb=0.0)
    train_kw = dict(batch_size=B, end_iter=100, learning_rate=0.0,
                    warm_up_end=1.0, anneal_end=2.0, fix_geo_end=0.0,
                    near=0.05, far=4.5)
    init = dict(variance_init=0.5, beta_init=0.5, gamma_init=0.3,
                zeta_init=0.3, requires_grad_beta=False,
                requires_grad_zeta=False)
    jst = jstate.init_train_state(0, jucfg, **init)
    jp0 = dict(_sorted_items(jax.tree.map(np.asarray, jst.params["udf"])))
    flags = {k: bool(getattr(jst, k)) for k in convert.FLAG_KEYS}
    tst = convert.make_state(
        convert.params_from_numpy(jax.tree.map(np.asarray, jst.params),
                                  tucfg, device="cpu"), 0, "cpu", flags=flags)
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    jpool = jds.RayPool(edges=jnp.zeros((1, 4)), cdf=jnp.zeros((1, 4)),
                        intrinsics_inv=jnp.eye(3)[None], rot=jnp.eye(3)[None],
                        origin=jnp.zeros((1, 3)), H=2, W=2, n_images=1)
    jfn = jstep.build_train_step(
        jstep.TrainConfig(**train_kw),
        jr.RenderConfig(sampler_precision="highest", **render_kw), jucfg, 1,
        donate=False, sample_fn=lambda s, p, k: (jbatch, jnp.int32(0)))
    chained = tstep.build_chained_train_step(
        tstep.TrainConfig(**train_kw),
        tr.RenderConfig(sampler_precision="highest", **render_kw), tucfg,
        1, 3, sample_fn=lambda s, p: (tbatch, 0))
    jrows = []
    for _ in range(3):
        jst, m = jfn(jst, jpool)
        jrows.append([float(m[k]) for k in tstep.METRIC_KEYS])
    rows = chained(tst, None).numpy()
    assert rows.shape == (3, len(tstep.METRIC_KEYS))
    for i, (got, want) in enumerate(zip(rows, jrows)):
        for k, g, w in zip(tstep.METRIC_KEYS, got, want):
            assert g == pytest.approx(w, rel=2e-5, abs=1e-6), (i, k)

    jp = dict(_sorted_items(jax.tree.map(np.asarray, jst.params["udf"])))
    field_move = max(np.abs(jp[p] - jp0[p]).max() for p in jp0)
    for path, g in _sorted_items(tst.params["udf"]):
        w, g = jp[path], g.detach().numpy()
        atol = (1e-2 * np.abs(w - jp0[path]).max() if w.size > 1
                else 5e-2 * field_move)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol + 1e-7,
                                   err_msg=path)
    _field_close(tst.opt.mu["udf"], jax.tree.map(np.asarray,
                                                 jst.opt.mu["udf"]), 3e-4)
    _field_close(tst.opt.nu["udf"], jax.tree.map(np.asarray,
                                                 jst.opt.nu["udf"]), 6e-4)
    for (path, g), (_, w) in zip(_sorted_items(tst.opt.count), _sorted_items(
            jax.tree.map(np.asarray, jst.opt.count))):
        assert float(g) == float(w), path
    for group in ("variance", "beta"):
        for (path, g), (_, w) in zip(
                _sorted_items(tst.params[group]),
                _sorted_items(jax.tree.map(np.asarray, jst.params[group]))):
            assert float(g.detach()[0]) == float(w[0]), path
    for k in convert.FLAG_KEYS:
        assert bool(getattr(tst, k)) == bool(getattr(jst, k)), k
    assert tst.step == int(jst.step) == 3


def _event_files(runner) -> dict:
    """The validation images and checkpoints a run left, by kind."""
    out = {}
    for kind in ("edge_maps", "normals", "depths"):
        out[kind] = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(runner.base_exp_dir, kind, "*.png")))
    return out


@pytest.mark.parametrize("end_iter", [20, 22])
def test_runner_chain_lands_events_on_the_chain_1_steps(tmp_path, monkeypatch,
                                                        end_iter):
    """With the default chain (5 for these cadences) the runner dispatches
    chains, then single steps for a tail that no chain fits (end 22), and
    its history, validations and checkpoints are those of a chain-1 run:
    one history row per step, events on the same steps."""
    built = []
    real = trunner.build_chained_train_step

    def spy(*args, **kwargs):
        built.append(args[4])
        return real(*args, **kwargs)

    monkeypatch.setattr(trunner, "build_chained_train_step", spy)
    cadences = dict(report_freq=5, save_freq=10, val_freq=10)
    runs = {}
    for chain in (0, 1):
        path = _conf(tmp_path / f"chain{chain}", end_iter,
                     steps_per_dispatch=chain, **cadences)
        runs[chain] = cli.main(["--conf", path, "--device", "cpu"])
    assert built == [5]
    got, want = runs[0], runs[1]
    assert [h["step"] for h in got.history] == list(range(1, end_iter + 1))
    assert [h for h in got.history] == [h for h in want.history]
    assert [s for s, _ in got.timeline] == [s for s, _ in want.timeline]
    assert _event_files(got) == _event_files(want)
    assert _event_files(got)["edge_maps"][-1].startswith("00000020_")
    a = native.load_pytree(os.path.join(got._ckpt_dir(), "ckpt_best.npz"))
    b = native.load_pytree(os.path.join(want._ckpt_dir(), "ckpt_best.npz"))
    _assert_same(_flat(a), _flat(b))
    _assert_same(_state_arrays(got.state), _state_arrays(want.state))
    assert got.captured_launches == got.replayed_launches == {}


def test_stopped_chained_run_resumes_exactly(tmp_path, monkeypatch):
    """`--stop_at` then `--is_continue` with a chain of 4 (the loss window
    shortened to 4 steps so that the stop grid is small): the state, best
    checkpoint and losses of the chained run that did not stop, and of a
    chain-1 run."""
    monkeypatch.setattr(trunner, "LOSS_WINDOW", 4)
    cadences = dict(report_freq=4, save_freq=4, val_freq=100)
    assert trunner.dispatch_chain(0, *cadences.values()) == 4
    runs = {}
    for name, chain in (("whole", 0), ("split", 0), ("eager", 1)):
        runs[name] = _conf(tmp_path / name, 12, steps_per_dispatch=chain,
                           **cadences)
    whole = cli.main(["--conf", runs["whole"], "--device", "cpu"])
    eager = cli.main(["--conf", runs["eager"], "--device", "cpu"])
    first = cli.main(["--conf", runs["split"], "--device", "cpu",
                      "--stop_at", "8"])
    assert first.state.step == 8
    second = cli.main(["--conf", runs["split"], "--device", "cpu",
                       "--is_continue"])
    assert second.state.step == 12
    losses = [h["loss"] for h in first.history + second.history]
    assert losses == [h["loss"] for h in whole.history] == [
        h["loss"] for h in eager.history]
    for ref in (whole, eager):
        _assert_same(_state_arrays(second.state), _state_arrays(ref.state))
        a = native.load_pytree(os.path.join(ref._ckpt_dir(),
                                            "ckpt_best.npz"))
        b = native.load_pytree(os.path.join(second._ckpt_dir(),
                                            "ckpt_best.npz"))
        _assert_same(_flat(b), _flat(a))


def test_profile_steps_writes_a_trace_and_dispatches_singly(tmp_path, caplog):
    """train.profile_steps: a torch.profiler trace of that many steps from
    the sixth, written under <base_exp_dir>/profile, with the chain forced
    to 1 where the cadences alone give 5."""
    path = _conf(tmp_path, 10, report_freq=5, save_freq=10, val_freq=100,
                 profile_steps=2)
    with caplog.at_level(logging.INFO, logger=trunner.logger.name):
        runner = cli.main(["--conf", path, "--device", "cpu"])
    assert "dispatching 1 step(s) a call" in caplog.text
    trace = os.path.join(runner.base_exp_dir, "profile", "trace.json")
    assert os.path.getsize(trace) > 0
    assert runner.state.step == 10
    assert [h["step"] for h in runner.history] == list(range(1, 11))
